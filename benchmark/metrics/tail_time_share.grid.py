"""Percent of the grid launches' time spent in the band's tail: launches
that start with fewer than 97% of the band's first launch's live lanes.  A
launch's time runs from its step's issue to the next live count's return
(the program's ``grid.launch`` spans, ``ops/trace.py``)."""
LAYER, SOURCE, MOVES = "Driver", "program_span", "samples_per_s"

TAIL = 0.97


def read(rec):
    try:
        from raytrace_tpu_torch.ops.launches import records
    except ImportError:  # a program without spans
        return None
    runs = [r.attrs for r in records(rec.window_start, rec.window_end)
            if r.name == "grid.launch" and "t_done" in r.attrs]
    total = sum(a["t_done"] - a["t_issued"] for a in runs)
    tail = sum(a["t_done"] - a["t_issued"] for a in runs if a["n_live"] < TAIL * a["n_first"])
    return 100.0 * tail / total if total > 0 else None
