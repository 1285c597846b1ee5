"""Median over the render calls of their bands' set-up time summed, in ms:
``pack_state``, the accumulator, the balanced table's copy and the paged
driver's first key, up to the first live count (the program's
``band.setup`` spans under each ``renderer.call``)."""
import statistics

LAYER, SOURCE, MOVES = "Driver", "program_span", "samples_per_s.short"


def read(rec):
    try:
        from raytrace_tpu_torch.ops.launches import records
    except ImportError:  # a program without spans
        return None
    recs = records(rec.window_start, rec.window_end)
    per_call = {r.id: 0.0 for r in recs if r.name == "renderer.call"}
    for r in recs:
        if r.name == "band.setup" and r.parent in per_call:
            per_call[r.parent] += r.t1 - r.t0
    return statistics.median(per_call.values()) * 1e3 if per_call else None
