"""Median over the paged tables' builds of their host reads of the device
(the ``syncs`` attribute of the program's ``paged.build`` spans)."""
import statistics

LAYER, SOURCE, MOVES = "Renderer", "program_span", "frame_ms_p95"


def read(rec):
    try:
        from raytrace_tpu_torch.ops.launches import records
    except ImportError:  # a program without spans
        return None
    n = [r.attrs["syncs"] for r in records(rec.window_start, rec.window_end)
         if r.name == "paged.build" and "syncs" in r.attrs]
    return statistics.median(n) if n else None
