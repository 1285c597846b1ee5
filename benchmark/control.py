"""The control of a cell's comparison: the reference in the program's place,
one precision lower; or, with ``--fault``, at full precision with a fault
planted.

    python -m benchmark.control --workload <cell> --seeds 11 12 13
    python -m benchmark.control --workload <cell> --seeds 11 12 13 --fault late-scene

The configurations state float32, so the control is the plain reference
computed in bfloat16 (the nearest lower precision with no TF32 matmul in
the path).  For each seed it takes the answers a run of that seed would
have judged, at the cell's own sizes (offline: the first ``check.answers``
images of the seed's sample stream; frames: the first ``check.answers``
frames), computes them with the bfloat16 reference and judges them with
``check.judge`` as if the program had produced them.  It prints one JSON
line per seed with ``px_off``.  The benchmark's own runs never run it; it
needs no program state, only the program's card profile (samples per
call).

``--fault late-scene`` (frames only) reads the least stale-state fault of
the frame loop: each frame rendered from the scene of the frame before it,
as if ``set_scene`` took effect a frame late.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_answers(cell: dict, seed: int, device) -> tuple:
    """(session, answers) of what a run of ``seed`` judges, without values."""
    from .loops import Session

    sess = Session(cell, seed, [device])
    tr = cell["traffic_data"]
    n = int(tr["check"]["answers"])
    if tr["loop"] == "frames":
        answers = [dict(time=sess.scene_time(i), spp=int(tr["spp"])) for i in range(n)]
    else:
        answers = [sess.image_answer(k) for k in range(n)]
    return sess, answers


def control_reading(cell: dict, seed: int, device, dtype=None) -> dict:
    """``check.judge`` of the reference in ``dtype`` (bfloat16) in the
    program's place."""
    import torch

    from . import check

    dtype = dtype or torch.bfloat16
    sess, answers = control_answers(cell, seed, device)
    cfg, tr = cell["config_data"], cell["traffic_data"]
    low = check.reference_values(cfg, answers, sess.pixels, device, dtype=dtype)
    return check.judge(cfg, tr, seed, answers, sess.pixels, device, program_values=low)


def late_scene_reading(cell: dict, seed: int, device) -> dict:
    """``check.judge`` of the float32 reference in the program's place, each
    frame rendered from the scene one frame earlier."""
    from . import check

    sess, answers = control_answers(cell, seed, device)
    cfg, tr = cell["config_data"], cell["traffic_data"]
    if tr["loop"] != "frames":
        raise ValueError("late-scene is a fault of the frame loop")
    dt = float(tr["dt"])
    late = [dict(a, time=a["time"] - dt) for a in answers]
    values = check.reference_values(cfg, late, sess.pixels, device)
    return check.judge(cfg, tr, seed, answers, sess.pixels, device, program_values=values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("late-scene",), default=None)
    args = ap.parse_args(argv)

    import torch

    from . import spec

    cell = spec.cell(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.fault:
            v = late_scene_reading(cell, seed, device)
        else:
            v = control_reading(cell, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.fault or "bfloat16",
                          "numbers": v["numbers"], "correct": v["correct"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
