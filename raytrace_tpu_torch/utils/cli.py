"""CLI: the reference's argument surface (main.cpp:10-64).

Port of ``raytrace_tpu/utils/cli.py``: the same flags with the same
defaults, the same ``unknown argument: X`` stderr line for an unknown flag,
the same exit codes (0, or 1 with one stderr line on an error), and the
same keyword arguments for ``api.ray_trace``.  ``main(argv, device)`` takes
the device as a Python argument ("cuda" by default; "cpu" runs the kernels'
plain torch versions).  ``--gpus N`` splits row bands over up to N devices
(one GPU gives one band); ``--serve`` runs the live viewer, or with
``--gpus`` above 1 or ``--frames`` the production loop; ``--frames`` alone
runs the animated frame loop.  ``--autotune`` applies the grid kernel's
tuned (M, J, K) for the device and mode, measuring it first if the cache has
none (``runtime/autotune.py``); with ``--full`` it also sweeps the grid
kernel's threads per block on a CUDA device (a later process builds at the
winner) and exits 1 on the CPU.
"""

from __future__ import annotations

import sys

HELP = """\
--help                            # Show this help infomation
--store                           # Store rendered image to file
--samples <count>                 # Total samples to render
--width <width>                   # Image width
--height <height>                 # Image height
--gpus <count>                    # Max used GPUs count
--out <path>                      # Output PNG path (default render.png)
--backend <auto|grid|paged|mega|matmul|bruteforce|pallas>  # Intersection backend
--depth <count>                   # Max bounce depth (default 50)
--time <seconds>                  # Scene animation time (default 0)
--samples-per-call <count>        # Progressive accumulation chunk
--accum <float32|float64>         # Cross-call accumulator dtype (Q5 dvec3)
--mode <exact|fast>               # fast = Russian-roulette production mode
--preview                         # Write the running PNG after each call
--frames <count>                  # Animated frame loop (0 = adaptive window)
--checkpoint <path>               # Resume/checkpoint progressive renders
--balance <probe-spp>             # Measured-cost lane balancing (grid;
                                  # bit-identical image; 0=off)
--autotune                        # Tune kernel knobs for this GPU (cached)
--full                            # With --autotune: also sweep the grid
                                  # kernel's block size (cross-process;
                                  # applied at the next process's build)
--serve <port>                    # Live progressive HTTP viewer (0 = auto);
                                  # with --gpus N>1 and/or --frames: the
                                  # animated multi-device production loop
                                  # (scene animation + per-device bands +
                                  # live tuner re-splits in one process)
"""


BACKENDS = ("auto", "grid", "paged", "mega", "matmul", "bruteforce", "pallas")


class CLIError(Exception):
    """Bad command line — reported as one readable stderr line (the
    reference's graceful unknown-arg handling, main.cpp:49, extended to
    missing/invalid values)."""


def parse_args(argv):
    """Hand-rolled argv loop like main.cpp:19-51. Returns kwargs for
    api.ray_trace, or None if --help was printed.  Raises CLIError on a
    missing/malformed flag value or unknown --backend."""
    kw = dict(samples=10, store_render_result=False, width=1920, height=1080,
              gpu_count=1)
    extras = {}
    i = 0
    while i < len(argv):
        a = argv[i]

        def _take():
            nonlocal i
            i += 1
            if i >= len(argv):
                raise CLIError(f"missing value for {a}")
            return argv[i]

        def _take_num(conv=int):
            v = _take()
            try:
                return conv(v)
            except ValueError:
                raise CLIError(f"invalid value for {a}: {v!r}") from None

        if a == "--help":
            print(HELP, end="")
            return None
        elif a == "--store":
            kw["store_render_result"] = True
        elif a == "--samples":
            kw["samples"] = _take_num()
        elif a == "--width":
            kw["width"] = _take_num()
        elif a == "--height":
            kw["height"] = _take_num()
        elif a == "--gpus":
            kw["gpu_count"] = _take_num()
        elif a == "--out":
            extras["out_path"] = _take()
        elif a == "--backend":
            b = _take()
            if b not in BACKENDS:
                raise CLIError(
                    f"unknown backend: {b!r} (expected one of "
                    f"{'|'.join(BACKENDS)})")
            extras["backend"] = b
        elif a == "--depth":
            extras["max_depth"] = _take_num()
        elif a == "--time":
            extras["scene_time"] = _take_num(float)
        elif a == "--samples-per-call":
            extras["samples_per_call"] = _take_num()
        elif a == "--accum":
            extras["accum_dtype"] = _take()
        elif a == "--mode":
            m = _take()
            if m not in ("exact", "fast"):
                raise CLIError(f"unknown mode: {m!r} (expected exact|fast)")
            extras["mode"] = m
        elif a == "--preview":
            extras["preview"] = True
        elif a == "--frames":
            extras["_frames"] = _take_num()
        elif a == "--checkpoint":
            extras["_checkpoint"] = _take()
        elif a == "--balance":
            extras["balance_spp"] = _take_num()
        elif a == "--autotune":
            extras["_autotune"] = True
        elif a == "--full":
            extras["_autotune_full"] = True
        elif a == "--serve":
            extras["_serve"] = _take_num()
        else:
            print(f"unknown argument: {a}", file=sys.stderr)
        i += 1
    kw.update(extras)
    return kw


def main(argv=None, device="cuda"):
    argv = sys.argv[1:] if argv is None else argv
    try:
        kw = parse_args(argv)
    except CLIError as e:
        print(e, file=sys.stderr)
        return 1
    if kw is None:
        return 0
    frames = kw.pop("_frames", None)
    checkpoint = kw.pop("_checkpoint", None)
    tune = kw.pop("_autotune", False)
    tune_full = kw.pop("_autotune_full", False)
    serve = kw.pop("_serve", None)
    try:
        if tune:
            # the cached (or a measured) operating point of this device and
            # mode; the image is bit-identical for any M, J, K and block
            from ..runtime import autotune as at

            if tune_full:
                at.cuda_device(device)  # the block sweep needs a card: refuse first
            tmode = kw.get("mode", "exact")
            tuned = at.load_tuned(at.device_kind(device), mode=tmode)
            if tuned is None:
                tuned = at.autotune(width=kw["width"], height=kw["height"], mode=tmode,
                                    device=device)
            if tune_full and "block" not in tuned:
                # the winner lands in the cache; this process keeps its build
                tuned = at.sweep_block(m=tuned["m"], j=tuned["j"], k=tuned["k"],
                                       mode=tmode, device=device)
            at.apply_tuned(tuned)
            kw.setdefault("pixels_per_lane", tuned["m"])
        if serve is not None:
            # live viewer and camera input (the headless analogue of the
            # reference's per-GPU windows, window.hpp:29-54)
            from ..config import RenderConfig

            cfg = RenderConfig(
                samples=kw["samples"], width=kw["width"], height=kw["height"],
                chips=kw["gpu_count"],
                max_depth=kw.get("max_depth", 50),
                backend=kw.get("backend", "auto"),
                samples_per_call=kw.get("samples_per_call"),
                mode=kw.get("mode", "exact"),
                scene_time=kw.get("scene_time", 0.0),
            )
            if kw["gpu_count"] > 1 or frames is not None:
                # the reference's operating mode: animated scene, per-device
                # bands and tuner re-splits in one loop (ray_trace.cpp:579-776)
                from ..runtime.production import ProductionLoop

                ProductionLoop(cfg, port=serve, device=device).run(
                    max_frames=frames if frames else None)
            else:
                from ..runtime.viewer import LiveViewer

                LiveViewer(cfg, port=serve, device=device).run()
        elif checkpoint is not None:
            from ..config import RenderConfig
            from ..ops.image import accum_to_u8
            from ..runtime.renderer import Renderer
            from .png import write_png

            cfg = RenderConfig(
                samples=kw["samples"], width=kw["width"], height=kw["height"],
                max_depth=kw.get("max_depth", 50), backend=kw.get("backend", "auto"),
                samples_per_call=kw.get("samples_per_call"),
                scene_time=kw.get("scene_time", 0.0),
            )
            r = Renderer(cfg, device=device)
            every = cfg.samples_per_call or max(1, cfg.samples // 20)
            accum, done = r.render_resumable(
                cfg.samples, checkpoint_path=checkpoint, checkpoint_every=every)
            if kw["store_render_result"]:
                write_png(kw.get("out_path", "render.png"),
                          accum_to_u8(accum, done).cpu().numpy())
        elif frames is not None:
            # animated frame loop (the reference's frame-loop mode, quirk Q8)
            from ..config import RenderConfig
            from ..runtime.frames import FrameLoop

            cfg = RenderConfig(
                samples=kw["samples"], width=kw["width"], height=kw["height"],
                chips=kw["gpu_count"],
                max_depth=kw.get("max_depth", 50),
                backend=kw.get("backend", "auto"),
            )
            pattern = None
            if kw["store_render_result"]:
                out = kw.get("out_path", "render.png")
                pattern = out.replace(".png", "_{0}.png") if "{0}" not in out else out
            FrameLoop(cfg, device=device).run(frames=frames, store_pattern=pattern)
        else:
            from ..api import ray_trace

            ray_trace(**kw, device=device)
    except Exception as e:  # main.cpp:61-63: catch, print, exit cleanly
        print(e, file=sys.stderr)
        return 1
    return 0
