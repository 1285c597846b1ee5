"""Paged kernel launches in the window (the wrapper's ``launches``
counter) per million pixel-samples completed."""
from benchmark.metrics import window_samples

LAYER, SOURCE, MOVES = "Driver", "program_counter", "samples_per_s.short"


def read(rec):
    n = rec.counters.get("launches.paged", 0)
    return n / (window_samples(rec) / 1e6) if n and rec.answers else None
