"""Percent of the cards' time in the window's band calls in which a card
has finished its band and waits for the slowest: over the program's
``bands.call`` spans (``parallel/sharding.py``), the sum over their bands
of (the call's end - the band's end, its ``bands.band`` span,
``parallel/devices.py``) over the bands times the calls' durations."""
LAYER, SOURCE, MOVES = "Parallel", "program_span", "samples_per_s.short"


def read(rec):
    try:
        from raytrace_tpu_torch.ops.launches import records
    except ImportError:  # a program without spans
        return None
    recs = records(rec.window_start, rec.window_end)
    calls = {r.id: r for r in recs if r.name == "bands.call"}
    bands = {}
    for r in recs:
        if r.name == "bands.band" and r.parent in calls:
            bands.setdefault(r.parent, []).append(r)
    wait = card = 0.0
    for cid, own in bands.items():
        call = calls[cid]
        wait += sum(call.t1 - b.t1 for b in own)
        card += len(own) * (call.t1 - call.t0)
    return 100.0 * wait / card if card > 0 else None
