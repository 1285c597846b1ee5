"""Median host time of the paged tables' build in ms, its host reads of the
device included (the program's ``paged.build`` spans inside
``scene.prepare``)."""
import statistics

LAYER, SOURCE, MOVES = "Renderer", "program_span", "frame_ms_p95"


def read(rec):
    try:
        from raytrace_tpu_torch.ops.launches import records
    except ImportError:  # a program without spans
        return None
    ms = [(r.t1 - r.t0) * 1e3 for r in records(rec.window_start, rec.window_end)
          if r.name == "paged.build"]
    return statistics.median(ms) if ms else None
