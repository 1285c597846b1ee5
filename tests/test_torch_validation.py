"""Port: the validation gates (runtime/validation.py) on the CPU.

The gates take the JAX package's configurations and pass rules and return
its dicts' keys; here they run the kernels' plain torch versions
(``device="cpu"``), where every step is IEEE and one formula, so the bitwise
gates hold exactly: the merged calls == the host loop, four row bands == the
whole frame, grid == mega in exact and fast mode.  The golden gates pass
against the CPU-oracle goldens in ``tests/data``, and fast mode passes its
statistical gate against exact mode (at 8 spp here, the card runs the JAX
package's 64).  On the card chip_smoke.py runs every gate.
"""

import pytest
import torch

from raytrace_tpu_torch.runtime import validation

torch.set_num_threads(1)

BITWISE_KEYS = {"diff_px", "total_px", "bit_identical", "max_diff"}


def test_merge_check():
    res = validation.merge_check(device="cpu")
    assert set(res) == BITWISE_KEYS | {"check"} and res["check"] == "call_merge==host_loop"
    assert res["bit_identical"] and res["diff_px"] == 0 and res["total_px"] == 128 * 72


def test_bandsplit_check():
    res = validation.bandsplit_check(device="cpu")
    assert set(res) == BITWISE_KEYS | {"check", "backend"}
    assert res["check"] == "bandsplit(4)==whole" and res["bit_identical"], res


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_bitident_check(mode):
    res = validation.bitident_check("grid", "mega", mode=mode, device="cpu")
    assert set(res) == BITWISE_KEYS | {"backends", "mode"}
    assert res["backends"] == "grid==mega" and res["bit_identical"], res


@pytest.mark.parametrize("backend, multi_tile", [("grid", False), ("mega", False),
                                                 ("bruteforce", False), ("grid", True)])
def test_golden_check(backend, multi_tile):
    res = validation.golden_check(backend, multi_tile=multi_tile, device="cpu")
    assert set(res) == {"backend", "mode", "bad_px", "total_px", "max_diff", "mean_rel",
                        "tile_p95_z", "psnr_db", "ok"}
    assert res["ok"], res
    assert res["total_px"] == (128 * 72 if multi_tile else 24 * 14)
    # the rules of chip_smoke.py phase 4: <= 3 of 336 px off by > 1e-3
    # single-tile (the oracle's own chaos budget), <= 1% multi-tile
    assert res["bad_px"] <= (92 if multi_tile else 3), res


def test_fast_check():
    res = validation.fast_check(spp=8, device="cpu")
    assert set(res) == {"check", "rr", "spp", "mean_rel", "tile_p95_z", "psnr_db", "ok"}
    assert res["ok"] and res["spp"] == 8 and res["rr"] == [1, 16, 0.05], res


def test_gates_default_to_the_card():
    """Without a CUDA device a gate raises unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        validation.merge_check()
