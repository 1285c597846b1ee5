"""Port parity: the ``pallas`` and ``matmul`` closest-hit backends.

``ops/pallas_intersect.py`` holds kernel 4's wrapper and its plain torch
version (the CPU runs the plain version; the CUDA kernel is compared with it
on the card, tests/test_torch_cuda.py and chip_smoke.py).  Both are held
against the JAX kernel (``_intersect_pallas_padded``, Pallas interpret mode)
and the JAX ``intersect_matmul`` on seeded rays against the book scene's
table, on the edge cases of tests/test_intersect.py, and through whole
renders against the port's spec path and the oracle golden with the JAX
package's statistical rules (tests/test_trace_golden.py:108-115,
tests/test_golden_fullscene.py:55-60).

Tolerances: XLA:CPU contracts FMAs, so t agrees only to float noise (1e-5
relative on most rays; up to ~1e-3 on the ground sphere, whose expanded
quadratic cancels ~1e6-sized terms) and a grazing ray may flip between hit
and miss (hit masks equal on >= 99.9% of rays); where both pick the same
sphere, its 16 attribute columns are the same table entries, bit for bit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.models.scene import generate_random_scene as j_book
from raytrace_tpu.ops import intersect as jint
from raytrace_tpu.ops import pallas_intersect as jpk
from raytrace_tpu_torch.models.scene import generate_random_scene, three_sphere_scene
from raytrace_tpu_torch.ops import intersect, pallas_intersect, trace
from raytrace_tpu_torch.runtime.renderer import reference_camera

torch.set_num_threads(1)

TMIN, TMAX = 0.001, 10000.0
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_fullscene_24x14_2spp_d12.npy")


@pytest.fixture(scope="module")
def rays():
    """2048 seeded rays through the book scene (tests/test_intersect.py's
    distribution) and the scene's packed table."""
    rng = np.random.default_rng(3)
    o = np.float32(rng.normal(0, 4, (2048, 3)) + [0, 3, 0])
    d = np.float32(rng.normal(0, 1, (2048, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sc = generate_random_scene(0.0)
    return o, d, sc, intersect.sphere_table(sc)


def _jax_pallas(o, d, table):
    n = o.shape[0]
    n_pad = -(-n // jpk.TILE_N) * jpk.TILE_N
    rays8 = np.zeros((8, n_pad), np.float32)
    rays8[0:3, :n] = o.T
    rays8[3:6, :n] = d.T
    t, attrs = jpk._intersect_pallas_padded(rays8, table, interpret=True)
    return np.asarray(t)[:n], np.asarray(attrs)[:n]


def _index_table(table):
    """The table with each row's index in attribute column 0."""
    tab = table.copy()
    tab[:, 8] = np.arange(table.shape[0], dtype=np.float32)
    return tab


def test_fused_kernel_matches_jax(rays):
    o, d, sc, table = rays
    assert np.array_equal(table, jpk.sphere_table(j_book(0.0)))
    t_j, a_j = _jax_pallas(o, d, table)
    i_j = _jax_pallas(o, d, _index_table(table))[1][:, 0].astype(np.int64)
    before = pallas_intersect.intersect_shade_pallas_plain.launches
    t_p, hit_p, a_p = (x.numpy() for x in pallas_intersect.intersect_shade_pallas(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(table)))
    assert pallas_intersect.intersect_shade_pallas_plain.launches == before + 1
    i_p = pallas_intersect.intersect_pallas(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(table[:, :3].T.copy()),
        torch.from_numpy(table[:, 3]), torch.from_numpy(table[:, 4] > 0), TMIN, TMAX)[1].numpy()
    hit_j = t_j < jint.BIG
    assert (hit_p == hit_j).mean() >= 0.999
    both = hit_p & hit_j & (i_p == i_j)
    assert both.mean() > 0.3  # the rays really hit the scene
    assert np.array_equal(a_p[both], a_j[both])
    # t: the ground sphere's c = oo - 2 co + kc cancels ~1e6-sized terms, and
    # XLA's FMA in the JAX kernel moves t there by up to ~1e-3 relative
    # (measured: 94.4% of these rays within 1e-5, the largest 1.4e-3)
    rel = np.abs(t_p[both] - t_j[both]) / np.abs(t_j[both])
    assert (rel <= 1e-5).mean() >= 0.93
    assert rel.max() <= 1e-2
    # a ray that hits nothing gets row 0's attributes (the one-hot product)
    miss = ~hit_p & ~hit_j
    assert miss.any()
    assert np.array_equal(a_p[miss], np.broadcast_to(table[0, 8:], a_p[miss].shape))
    assert np.array_equal(a_j[miss], a_p[miss])


def test_matmul_matches_jax(rays):
    o, d, sc, _ = rays
    valid = np.arange(sc.centers.shape[0]) < int(sc.n_spheres)
    kc = intersect.sphere_constants(sc.centers, sc.radii)
    t_j, i_j, h_j = (np.asarray(x) for x in jint.intersect_matmul(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(sc.centers.T.copy()),
        jnp.asarray(kc), jnp.asarray(valid), TMIN, TMAX))
    t_p, i_p, h_p = (x.numpy() for x in intersect.intersect_matmul(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(sc.centers.T.copy()),
        torch.from_numpy(kc), torch.from_numpy(valid), TMIN, TMAX))
    assert (h_p == h_j).mean() >= 0.999
    both = h_p & h_j & (i_p == i_j)
    assert (i_p[h_p & h_j] == i_j[h_p & h_j]).mean() >= 0.999
    assert np.allclose(t_p[both], t_j[both], rtol=1e-5, atol=0)


def _single_sphere(center, radius):
    centers = np.zeros((8, 3), np.float32)
    radii = np.zeros((8,), np.float32)
    centers[0] = center
    radii[0] = radius
    return centers, radii, np.arange(8) < 1


# tests/test_intersect.py's cases: (sphere, o, d, expected (hit, t or None))
EDGES = {
    "head_on": (((0, 0, 5), 1.0), (0, 0, 0), (0, 0, 1), (True, 4.0)),
    "inside_far_root": (((0, 0, 0), 2.0), (0, 0, 0), (0, 0, 1), (True, 2.0)),
    "miss": (((0, 0, 5), 1.0), (0, 0, 0), (0, 1, 0), (False, None)),
    "behind_origin": (((0, 0, -5), 1.0), (0, 0, 0), (0, 0, 1), (False, None)),
    "tmin_far_root": (((0, 0, 1.0), 1.0), (0, 0, 0.0000005), (0, 0, 1), (True, 2.0)),
}


@pytest.mark.parametrize("name", list(EDGES))
def test_edge_cases(name):
    (center, radius), o, d, (want_hit, want_t) = EDGES[name]
    centers, radii, valid = _single_sphere(center, radius)
    o = np.array([o], np.float32)
    d = np.array([d], np.float32)
    kc = intersect.sphere_constants(centers, radii)
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(centers.T.copy()),
            torch.from_numpy(kc), torch.from_numpy(valid), TMIN, TMAX)
    j_t, j_i, j_h = (np.asarray(x) for x in jpk.intersect_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(centers.T.copy()),
        jnp.asarray(kc), jnp.asarray(valid), TMIN, TMAX))
    for fn in (pallas_intersect.intersect_pallas, intersect.intersect_matmul):
        t, idx, hit = (x.numpy() for x in fn(*args))
        assert bool(hit[0]) == want_hit == bool(j_h[0]), fn.__name__
        if want_hit:
            assert idx[0] == 0 == j_i[0]
            assert abs(t[0] - want_t) < 1e-4 and abs(j_t[0] - want_t) < 1e-4
        else:
            assert t[0] >= float(intersect.BIG) * 0.99
    p_t = pallas_intersect.intersect_pallas(*args)[0].numpy()
    assert np.allclose(p_t, j_t, rtol=1e-5, atol=0)


def test_valid_prefix_scan_changes_no_bit(rays):
    """``n_valid``: scanning only the table's valid prefix (the book table's
    488 of 512 rows) gives every ray the same t, hit and attributes as
    scanning every row; an empty prefix is a miss with row 0's attributes;
    a prefix longer than the table raises."""
    o, d, sc, table = (torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                       for x in rays)
    n = int(sc.n_spheres)
    assert n < table.shape[0]
    full = pallas_intersect.intersect_shade_pallas(o, d, table)
    pref = pallas_intersect.intersect_shade_pallas(o, d, table, n_valid=n)
    assert bool(full[1].any())
    for a, b in zip(full, pref):
        assert torch.equal(a, b)
    t0, hit0, a0 = pallas_intersect.intersect_shade_pallas(o, d, table, n_valid=0)
    assert not bool(hit0.any()) and bool((t0 == float(intersect.BIG)).all())
    assert torch.equal(a0, table[0, 8:].expand_as(a0))
    with pytest.raises(ValueError, match="n_valid"):
        pallas_intersect.intersect_shade_pallas(o, d, table, n_valid=table.shape[0] + 1)


def test_padding_rows_never_hit():
    sc = three_sphere_scene()
    table = intersect.sphere_table(sc)
    o = torch.tensor([[0, 0.5, -3]], dtype=torch.float32)  # ray through the origin
    d = torch.tensor([[0, -0.1664, 0.986]], dtype=torch.float32)
    t, hit, attrs = pallas_intersect.intersect_shade_pallas(o, d, torch.from_numpy(table))
    valid = torch.arange(table.shape[0]) < int(sc.n_spheres)
    kc = torch.from_numpy(intersect.sphere_constants(sc.centers, sc.radii))
    for fn in (pallas_intersect.intersect_pallas, intersect.intersect_matmul):
        _, idx, h = fn(o, d, torch.from_numpy(sc.centers.T.copy()), kc, valid, TMIN, TMAX)
        assert bool(h[0]) and int(idx[0]) < int(sc.n_spheres)
    assert bool(hit[0])
    i = int(intersect.intersect_matmul(o, d, torch.from_numpy(sc.centers.T.copy()), kc,
                                       valid, TMIN, TMAX)[1][0])
    assert torch.equal(attrs[0], torch.from_numpy(table[i, 8:]))


def _render(backend, m=1):
    ds = trace.device_scene_from_numpy(
        trace.prepare_scene(generate_random_scene(0.0)), "cpu")
    vp = trace.viewport_arrays(reference_camera(), 24, 14)
    return trace.render_band(
        ds, vp, band_h=14, width=24, y0=0, seed_y0=0, offset_x=0, spp=2,
        number=0, max_depth=12, backend=backend, pixels_per_lane=m).numpy()


def test_pallas_backend_matches_spec_path():
    """tests/test_trace_golden.py:108-115: > 85% of pixels within 0.05 of
    the bruteforce render and the mean within 5%."""
    before = pallas_intersect.intersect_shade_pallas_plain.launches
    pk = _render("pallas", m=4)
    assert pallas_intersect.intersect_shade_pallas_plain.launches > before
    bf = _render("bruteforce")
    close = np.abs(bf - pk).max(axis=2) < 0.05
    assert close.mean() > 0.85, f"only {close.mean():.2%} pixels match"
    assert abs(bf.mean() - pk.mean()) / bf.mean() < 0.05


def test_matmul_backend_matches_golden():
    """tests/test_golden_fullscene.py:55-60: > 80% of pixels within 0.05 of
    the oracle golden and the mean within 10%."""
    out = _render("matmul")
    golden = np.load(GOLDEN)
    close = np.abs(out - golden).max(axis=2) < 0.05
    assert close.mean() > 0.80
    assert abs(out.mean() - golden.mean()) / golden.mean() < 0.1
