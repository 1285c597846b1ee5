"""Median host time of a paged launch from its live count's return to the
step's issue, while the card has nothing queued (the program's
``paged.launch`` spans, ``ops/trace.py``), in microseconds."""
import statistics

LAYER, SOURCE, MOVES = "Driver", "program_span", "samples_per_s.short"


def read(rec):
    try:
        from raytrace_tpu_torch.ops.launches import records
    except ImportError:  # a program without spans
        return None
    gaps = [r.attrs["t_issued"] - r.attrs["t_counted"]
            for r in records(rec.window_start, rec.window_end) if r.name == "paged.launch"]
    return statistics.median(gaps) * 1e6 if gaps else None
