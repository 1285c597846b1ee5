"""Port parity: the paged kernel's section-cost probes (``ablate``).

The JAX package's paged-kernel switches for ``scripts/paged_iterbench.py``
(ops/pagedkernel.py ``SWITCHES``: the removals ``cut_*`` and ``freeze``).
On the CPU the step wrapper runs the plain version; each switch is held
against the JAX ``paged_megakernel_step`` in Pallas interpret mode (carried
attributes, no overflow table) with the same ``ablate``, five iterations
from the same packed state of a 2000-sphere field, by
test_torch_paged.py's rule: the discrete state (u32 rows, pixel coords,
throughput; under ``cut_shade`` the first two) bit-equal on >= 97% of
lanes, and on those lanes the winner key on >= 99.9%.
The CUDA variants are held against these plain versions on the card
(chip_smoke.py phase 11).
"""

import re

import numpy as np
import pytest
import torch

from raytrace_tpu.ops import pagedkernel as jpaged
from raytrace_tpu_torch.models.scene import random_sphere_field
from raytrace_tpu_torch.ops import pagedkernel, trace
from raytrace_tpu_torch.runtime.renderer import reference_camera

torch.set_num_threads(1)

J_ACC = 21  # the JAX state's acc rows: 21 + 3m + c, then the carried attrs
DISCRETE_F_ROWS = [pagedkernel.R_FX, pagedkernel.R_FY, pagedkernel.R_THR,
                   pagedkernel.R_THR + 1, pagedkernel.R_THR + 2]
# measured shares of lanes whose discrete state equals JAX's after five
# iterations (test_torch_paged.py reads 98.7% without a switch):
# cut_globals 98.63%, cut_init 100%, cut_fetch 99.95%, cut_quad 99.98%,
# cut_resolve 98.56%, cut_gsel 98.61%, cut_shade 99.95%, cut_tea 98.78%,
# cut_camera 99.02%, freeze 100%
# under cut_shade the throughput is a product of ray directions, which
# XLA's rsqrt normalizes differently in the last bit (test_torch_probes.py;
# with the throughput 44.41%)
NO_THROUGHPUT = ("cut_shade",)
# under cut_fetch a winner's key is its page's plus ox, and under
# cut_resolve its attributes are its key, so XLA's float noise in o reaches
# the key itself (measured equal on 91.5% and 99.88% of the equal lanes):
# the key is not compared there
NO_KEY = ("cut_fetch", "cut_resolve")


@pytest.fixture(scope="module")
def dense():
    return trace.prepare_scene(random_sphere_field(2000, seed=1, extent=7.0))


def _jax_layout(f, acc, m_slots, n_lanes, na):
    """The JAX f32 paged state rows from the port's state and home-order
    accumulator (lane k is lane0 k; test_torch_paged.py's map)."""
    f = f.numpy()
    out = np.zeros((jpaged.pf_rows(m_slots, na), f.shape[1]), np.float32)
    out[:J_ACC] = f[:J_ACC]
    pix = np.arange(m_slots)[:, None] * n_lanes + np.arange(n_lanes)[None, :]
    acc_pad = np.zeros((m_slots * n_lanes, 3), np.float32)
    acc_pad[: acc.shape[0]] = acc.numpy()
    out[J_ACC : J_ACC + 3 * m_slots, :n_lanes] = (
        acc_pad[pix.reshape(-1)].reshape(m_slots, n_lanes, 3)
        .transpose(0, 2, 1).reshape(3 * m_slots, n_lanes))
    a0 = J_ACC + 3 * m_slots
    out[a0 : a0 + na] = f[pagedkernel.R_ATT : pagedkernel.R_ATT + na]
    return out


@pytest.mark.parametrize("switch", pagedkernel.SWITCHES)
def test_switch_matches_jax_interpret(dense, switch):
    """Five iterations with the switch from the same packed state (one JAX
    TILE of 4096 lanes, M=2, depth 12)."""
    ds = trace.device_scene_from_numpy(dense, "cpu")
    vp = trace.viewport_arrays(reference_camera(), 128, 64)
    f, u, scal, vpr, geom = trace.pack_state(
        ds, vp, backend="paged", band_h=64, width=128, y0=0, seed_y0=0,
        offset_x=0, spp=2, number=0, pixels_per_lane=2, lane_pad=jpaged.TILE)
    kw = dict(geom, max_depth=12, skip_tmax=True, k_steps=5)
    na = pagedkernel.n_carry(False, False)
    g = dense.paged
    acc0 = trace.home_accum(None, geom["p_total"], "cpu")
    fj, uj = jpaged.paged_megakernel_step(
        scal.numpy(), vpr.numpy(), g.gscal, g.gtab, g.geom, g.lids, g.attrs,
        _jax_layout(f, acc0, 2, geom["n_lanes"], na), u.numpy().view(np.uint32),
        interpret=True, five=False, textured=False, carry=True, ablate=(switch,), **kw)
    fj, uj = np.asarray(fj), np.asarray(uj).view(np.int32)
    acc = acc0.clone()
    fp, up, key = pagedkernel.paged_megakernel_step(scal, vpr, ds.paged, f, u, acc,
                                                    ablate=(switch,), **kw)
    assert torch.equal(key, trace._rebucket_key(fp, up, ds.paged.gscal))
    fpj, up = _jax_layout(fp, acc, 2, geom["n_lanes"], na), up.numpy()
    rows = DISCRETE_F_ROWS[:2] if switch in NO_THROUGHPUT else DISCRETE_F_ROWS
    same = (up == uj).all(axis=0) & (fpj[rows] == fj[rows]).all(axis=0)
    assert same.mean() >= 0.97, \
        f"{switch}: discrete state equal on {same.mean():.2%}"
    # the winner key on >= 99.9% of those lanes (a grazing hit at another t)
    if switch not in NO_KEY:
        key_same = fpj[pagedkernel.R_BKEY, same] == fj[pagedkernel.R_BKEY, same]
        assert key_same.mean() >= 0.999, f"{switch}: key equal on {key_same.mean():.2%}"
    # the switch did something: the state is not the base launch's
    fb, ub, _ = pagedkernel.paged_megakernel_step(scal, vpr, ds.paged, f, u,
                                                  acc0.clone(), **kw)
    assert not (torch.equal(fb, fp) and torch.equal(ub, torch.from_numpy(up)))
    if switch == "freeze":  # a marching lane keeps its cell
        march = u[pagedkernel.U_MARCH] != 0
        assert torch.equal(torch.from_numpy(up)[pagedkernel.U_CELL, march],
                           u[pagedkernel.U_CELL, march])


def test_paged_iterbench_script(monkeypatch, capsys):
    """``paged_iterbench --device cpu`` on the 100k field at 32x16, M=2,
    two launches a round: the warm-up's page-spread lines and every removal
    under ``freeze``; ``CARRY=0`` raises naming ROADMAP."""
    from raytrace_tpu_torch.scripts import paged_iterbench

    monkeypatch.setattr(paged_iterbench, "W", 32)
    monkeypatch.setattr(paged_iterbench, "H", 16)
    monkeypatch.setattr(paged_iterbench, "M", 2)
    for k, v in dict(INVOKES="2", ROUNDS="1").items():
        monkeypatch.setenv(k, v)
    med = paged_iterbench.main(["--device", "cpu"])
    assert list(med) == paged_iterbench.VARIANTS.split(",")
    out = capsys.readouterr().out
    assert "per-chunk LINEAR page spread" in out and "per-chunk 2-D BOX" in out
    assert re.search(r"base median: .*us per tile-iteration, 2 tiles x 20 iterations", out)
    monkeypatch.setenv("CARRY", "0")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        paged_iterbench.main(["--device", "cpu"])
