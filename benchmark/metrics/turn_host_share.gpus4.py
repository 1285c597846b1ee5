"""Percent of the window's band calls that the one dispatching thread spends
inside the bands' steps, issuing their launches: the sum of the program's
``bands.call`` spans' ``host_step_s`` (``parallel/devices.py``
``run_in_turns``) over the sum of their durations.  Near 100, the host sets
the pace of every card."""
LAYER, SOURCE, MOVES = "Driver", "program_span", "samples_per_s.short"


def read(rec):
    try:
        from raytrace_tpu_torch.ops.launches import records
    except ImportError:  # a program without spans
        return None
    calls = [r for r in records(rec.window_start, rec.window_end)
             if r.name == "bands.call" and "host_step_s" in r.attrs]
    total = sum(r.t1 - r.t0 for r in calls)
    return 100.0 * sum(r.attrs["host_step_s"] for r in calls) / total if total > 0 else None
