"""Median host time in ms of the scene's transfer to the card inside
``set_scene`` (the program's ``scene.upload`` spans)."""
import statistics

LAYER, SOURCE, MOVES = "Driver", "program_span", "frame_ms_p95"


def read(rec):
    try:
        from raytrace_tpu_torch.ops.launches import records
    except ImportError:  # a program without spans
        return None
    ms = [(r.t1 - r.t0) * 1e3 for r in records(rec.window_start, rec.window_end)
          if r.name == "scene.upload"]
    return statistics.median(ms) if ms else None
