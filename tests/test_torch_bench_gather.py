"""Port parity: the lane-gather probe of ``scripts/bench_gather.py``.

``raytrace_tpu_torch/scripts/bench_gather.py`` holds the wrappers of the
probe's two kernels (``run``, ``run_base``) and their plain torch versions:
the CPU runs the plain versions, and the CUDA kernels
(``csrc/bench_gather.cu``) are held against them on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 8).  Here the plain versions
are held against the JAX script's own kernel bodies (``_kernel``,
``_kernel_base``) run through ``pl.pallas_call(..., interpret=True)`` with
the script's VMEM specs, at its [16, 1024], on its seeded inputs and on
indices that are negative or wrap int32.

Tolerance: bit-equal, NaN positions equal.  Both sides add the same f32
values in the same order (acc + g from 0; an out-of-range row of axis 0 is
NaN on both), and the baseline's multiply and add are two roundings on both.

The shared-memory wavefront counter (``shared_wavefronts``,
``warp_wavefronts``) and the record-major copy's layout (``record_slot``
and ``record_quad``, mirrored by the kernel) are checked here too: on
hand-made warps whose counts follow from the bank model, as a layout that
holds every record twice and rebuilds the table from either copy, and on
the seeded inputs, whose counts PERF.md states.
"""

import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytrace_tpu_torch.scripts import bench_gather as bg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "scripts_bench_gather", os.path.join(ROOT, "scripts", "bench_gather.py"))
jbg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jbg)


def _jax(tab, idx, *, iters, axis=None):
    """The JAX script's kernel body (``axis=None``: the baseline's) in
    Pallas interpret mode, with the script's specs."""
    body = (functools.partial(jbg._kernel, iters=iters, axis=axis) if axis is not None
            else functools.partial(jbg._kernel_base, iters=iters))
    out = pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((jbg.R, jbg.T), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)(tab, idx)
    return np.asarray(out)


def _index(mode):
    """The script's inputs ("rand", "lane"), or "wide" (int32 indices over
    the whole range, some at the top so that ``idx + i`` wraps),
    "wide-lane" (the same per lane, broadcast over the rows), "mixed"
    (record-path and row-path warps in one block) or "lane-row" (per-lane
    indices on the row path in every warp): ``bg.check_inputs``."""
    return bg.check_inputs(mode)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.all((a == b) | (np.isnan(a) & np.isnan(b))))


def test_constants_are_the_scripts():
    assert (bg.R, bg.T, bg.ITERS) == (jbg.R, jbg.T, jbg.ITERS)


@pytest.mark.parametrize("iters", [1, 7])
@pytest.mark.parametrize("mode", ["rand", "lane", "wide", "wide-lane", "mixed",
                                  "lane-row"])
@pytest.mark.parametrize("axis", [1, 0])
def test_gather_matches_jax(axis, mode, iters):
    tab, idx = _index(mode)
    want = _jax(tab, idx, iters=iters, axis=axis)
    got = bg.run(torch.from_numpy(tab), torch.from_numpy(idx), iters=iters, axis=axis)
    assert _same(got.numpy(), want)
    nan = np.isnan(want).mean()
    # axis 1 stays in range; axis 0 reaches rows >= 16 for most indices
    assert nan == 0.0 if axis == 1 else nan > 0.9


@pytest.mark.parametrize("iters", [1, 7])
def test_base_matches_jax(iters):
    tab, idx = _index("rand")
    want = _jax(tab, idx, iters=iters)
    got = bg.run_base(torch.from_numpy(tab), torch.from_numpy(idx), iters=iters)
    assert _same(got.numpy(), want)


def test_cpu_runs_the_plain_versions_and_counts_them():
    tab, idx = (torch.from_numpy(a) for a in _index("rand"))
    for fn in (bg.run, bg.run_base, bg.run_plain, bg.run_base_plain):
        fn.launches = 0
    out = bg.run(tab, idx, iters=2, axis=1, blocks=3, per_block=True)
    base = bg.run_base(tab, idx, iters=2)
    assert out.shape == (3, bg.R, bg.T) and base.shape == (bg.R, bg.T)
    assert torch.equal(out[2], bg.run_plain(tab, idx, iters=2, axis=1))
    assert (bg.run.launches, bg.run_base.launches) == (0, 0)
    assert (bg.run_plain.launches, bg.run_base_plain.launches) == (2, 1)


def test_wrappers_reject_what_the_kernels_do_not_take():
    tab, idx = (torch.from_numpy(a) for a in _index("rand"))
    with pytest.raises(TypeError):
        bg.run(tab.double(), idx, iters=1, axis=1)
    with pytest.raises(ValueError):
        bg.run(tab[:8], idx[:8], iters=1, axis=1)
    with pytest.raises(ValueError):
        bg.run(tab, idx, iters=1, axis=2)
    with pytest.raises(ValueError):
        bg.run_base(tab, idx, iters=-1)


def test_main_on_cpu_prints_each_case(capsys):
    res = bg.main(["--device", "cpu", "--iters", "4"])
    lines = capsys.readouterr().out.splitlines()
    cases = [ln for ln in lines if ln.startswith("axis=")]
    assert [ln.split(":")[0] for ln in cases] == [
        f"axis={a} idx={m}" for a in (1, 0) for m in bg.INDEX_MODES]
    assert all("correct=True" in ln and "host clock" in ln for ln in cases)
    assert sum(ln.startswith("baseline add loop:") for ln in lines) == 1
    assert all(g["correct"] for g in res["gather"].values())
    assert res["blocks"] == [1] and res["base_ms"][1] > 0


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bg.main([])


def test_import_leaves_jax_out():
    code = ("import sys, chip_smoke, raytrace_tpu_torch.scripts.bench_gather; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'raytrace_tpu' or m.startswith('raytrace_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_check_inputs_cover_both_paths():
    assert bg.CHECK_MODES[:2] == bg.INDEX_MODES == ("rand", "lane")
    _, wide_lane = bg.check_inputs("wide-lane")
    assert (wide_lane == wide_lane[:1]).all() and (wide_lane[0] > 2**31 - 8).sum() > 100
    assert bg.record_warps(bg.check_inputs("wide-lane")[1]).all()
    assert not bg.record_warps(bg.check_inputs("rand")[1]).any()
    assert not bg.record_warps(bg.check_inputs("lane-row")[1]).any()
    mixed = bg.record_warps(bg.check_inputs("mixed")[1])
    # even warps broadcast their index over the rows, but warp 2's lane 5
    # differs in one row, so warp 2 takes the row path
    assert mixed.tolist() == [w % 2 == 0 and w != 2 for w in range(bg.T // bg.WARP)]
    with pytest.raises(ValueError):
        bg.check_inputs("bogus")


@pytest.mark.parametrize("case,width,want", [
    ("one word", 1, (1, 1)),
    ("one bank, distinct words", 1, (32, 32)),
    ("consecutive words", 1, (1, 1)),
    ("one slot", 4, (4, 4)),
    ("consecutive records", 4, (4, 4)),
    ("random records", 4, (4, 4)),
    ("one bank quad, distinct slots", 4, (32, 32)),
])
def test_warp_wavefronts_on_hand_made_warps(case, width, want):
    lanes = np.arange(bg.WARP)
    # the record path's loads at step 2 of an iteration
    rec = {"consecutive records": 64 + lanes,
           "random records": np.random.default_rng(3).integers(0, bg.T, bg.WARP)}
    addr = {"one word": np.full(bg.WARP, 77),
            "one bank, distinct words": 32 * lanes + 5,
            "consecutive words": 100 + lanes,
            "one slot": np.full(bg.WARP, 9),
            "one bank quad, distinct slots": 8 * lanes + 3}
    addr.update({k: bg.record_slot(j, bg.record_quad(2, lanes), lanes) for k, j in rec.items()})
    addr = addr[case]
    assert tuple(int(n) for n in bg.warp_wavefronts(addr, width)) == want


def test_unswizzled_records_crowd_two_bank_quads():
    # quad 1 of records 0 .. 31 in slot 4j + 1: bank quads 1 and 5 only
    w, q = bg.warp_wavefronts(4 * np.arange(bg.WARP) + 1, 4)
    assert (int(w), int(q)) == (16, 16)


@pytest.mark.parametrize("case,want", [
    # every lane of a warp on one word, per row: one wavefront a load
    ("one word", 512),
    # lane t on word t of its row: one wavefront a load
    ("consecutive words", 512),
    # the 32 lanes of a warp on 32 words of one bank: 32 a load
    ("one bank", 32 * 512),
    # consecutive records on the record path: four 128-bit loads of 4
    ("consecutive records", 512),
    # random records on the record path: the same
    ("random records", 512),
])
def test_shared_wavefronts_on_hand_made_blocks(case, want):
    lanes = np.broadcast_to(np.arange(bg.T, dtype=np.int32), (bg.R, bg.T))
    idx = {"one word": np.zeros((bg.R, bg.T), np.int32),
           "consecutive words": lanes + np.arange(bg.R, dtype=np.int32)[:, None],
           "one bank": np.broadcast_to((lanes % bg.WARP) * bg.WARP, (bg.R, bg.T)),
           "consecutive records": lanes,
           "random records": np.broadcast_to(
               np.random.default_rng(4).integers(0, bg.T, bg.T), (bg.R, bg.T))}[case]
    records = case.endswith("records")
    got = bg.shared_wavefronts(idx, axis=1, layout="paired" if records else "row")
    assert got == dict(warp=want, quarter=want,
                       record_warps=bg.T // bg.WARP if records else 0)


def test_record_slot_holds_each_record_twice_and_rebuilds_the_table():
    tab, _ = bg.inputs()
    j, q = np.meshgrid(np.arange(bg.T), np.arange(bg.QUADS), indexing="ij")
    # lane 0 reads copy 0, lane 4 copy 1: together they fill every slot once
    slots = np.stack([bg.record_slot(j, q, lane) for lane in (0, 4)])
    assert sorted(slots.ravel().tolist()) == list(range(2 * bg.R * bg.T // 4))
    # record j fills its own 128-byte line, copy c on the bank quads 4c .. 4c + 3
    assert ((slots // 8) == j).all() and (slots[1] % 8 == 4 + q).all()
    copy = np.full(2 * bg.R * bg.T, np.nan, np.float32)
    for c in range(2):
        # every (record, row) word has exactly one address in each copy
        words = (4 * slots[c][:, :, None] + np.arange(4)).reshape(bg.T, bg.R)
        assert len(np.unique(words)) == bg.R * bg.T
        copy[words] = tab.T  # record j: the column tab[:, j]
    for lane in range(bg.WARP):
        words = (4 * bg.record_slot(j, q, lane)[:, :, None] + np.arange(4)).reshape(bg.T, bg.R)
        assert np.array_equal(copy[words].T, tab)


def test_record_quad_spreads_a_quarter_warp_over_the_bank_quads():
    lanes = np.arange(bg.WARP)
    for lane in lanes:  # each lane loads every quad once an iteration
        assert sorted(int(bg.record_quad(k, lane)) for k in range(bg.QUADS)) == [0, 1, 2, 3]
    for k in range(bg.QUADS):  # whatever the records, 8 lanes on 8 bank quads
        for j in (np.zeros(bg.WARP, int), np.arange(bg.WARP), 7 * lanes + 3):
            quads = bg.record_slot(j, bg.record_quad(k, lanes), lanes) % 8
            assert (np.sort(quads.reshape(4, 8), axis=1) == np.arange(8)).all()


@pytest.mark.parametrize("mode,axis,layout,want", [
    ("rand", 1, "paired", (1741, 1741)),
    ("lane", 1, "paired", (512, 512)),
    ("lane", 1, "swizzled", (884, 1336)),
    ("lane", 1, "row", (1648, 1648)),
    ("lane", 1, "record", (2304, 2576)),
    ("wide-lane", 1, "paired", (512, 512)),
    ("mixed", 1, "paired", (1155, 1155)),
    ("mixed", 1, "swizzled", (1337, 1525)),
    ("lane-row", 1, "paired", (1651, 1651)),
    ("lane", 0, "paired", (512, 512)),
])
def test_seeded_counts_are_the_ones_perf_states(mode, axis, layout, want):
    _, idx = bg.check_inputs(mode)
    got = bg.shared_wavefronts(idx, axis=axis, layout=layout)
    assert (got["warp"], got["quarter"]) == want


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_119gather_bench_kernelILi0EEEvPKfPKiPfi
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
.L_x_1:
        /*0010*/                   VIMNMX.U32 R4, R2, R3, PT ;  /* 0x000000030204723c */
        /*0020*/                   SHF.R.U32.HI R5, RZ, 0xa, R4 ;
        /*0030*/                   LDS R6, [R5] ;
        /*0040*/                   FADD R7, R7, R6 ;
        /*0050*/                   IADD3 R2, R2, 0x400000, RZ ;
        /*0060*/               @P0 BRA `(.L_x_1) ;
        /*0070*/                   BRA 0x10 ;
        /*0080*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_118gather_base_kernelEPKfPfi
        /*0000*/                   BRA 0x0 ;
"""


def test_sass_loops_finds_each_backward_branch():
    loops = bg.sass_loops(SASS)
    assert list(loops) == ["_ZN12_GLOBAL__N_119gather_bench_kernelILi0EEEvPKfPKiPfi"]
    first, second = loops["_ZN12_GLOBAL__N_119gather_bench_kernelILi0EEEvPKfPKiPfi"]
    assert first == dict(instructions=6, ops={"VIMNMX.U32": 1, "SHF.R.U32.HI": 1, "LDS": 1,
                                             "FADD": 1, "IADD3": 1, "BRA": 1})
    assert second["instructions"] == 7 and second["ops"]["BRA"] == 2


SWIZZLES = {  # XOR masks of the slot within its 128-byte line, by line
    "line": lambda line: line & 7,
    "line ^ line >> 3": lambda line: (line ^ (line >> 3)) & 7,
    "line ^ line >> 3 ^ line >> 6": lambda line: (line ^ (line >> 3) ^ (line >> 6)) & 7,
    "line >> 1": lambda line: (line >> 1) & 7,
    "3 * line": lambda line: (3 * line) & 7,
}


@pytest.mark.parametrize("name", list(SWIZZLES))
def test_other_swizzles_count_within_the_spread_of_random_records(monkeypatch, name):
    """The one-copy record layout (two records a line, quad q at step q)
    with other XOR swizzles in place of ``_xor_slot``'s: on the seeded
    per-lane indices and the wrapping ones, every candidate lands in
    840-884 wavefronts (warp rule) and 1304-1363 (quarter rule), the spread
    of 32 random records over 8 bank quads, and none near the kernel's
    two-copy layout's 512."""
    mask = SWIZZLES[name]

    def slot(j, q):
        j = np.asarray(j)
        line = j >> 1
        return line * 8 + ((((j & 1) << 2) | q) ^ mask(line))

    if name == "line":
        j, q = np.meshgrid(np.arange(bg.T), np.arange(bg.QUADS), indexing="ij")
        assert np.array_equal(slot(j, q), bg._xor_slot(j, q))
    monkeypatch.setattr(bg, "_xor_slot", slot)
    for mode in ("lane", "wide-lane"):
        got = bg.shared_wavefronts(bg.check_inputs(mode)[1], axis=1, layout="swizzled")
        assert 840 <= got["warp"] <= 884 and 1304 <= got["quarter"] <= 1363
