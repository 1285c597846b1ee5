"""Frames completed in the window, over the time from the window's start to
the end of the last of them."""
from benchmark.metrics import window_seconds

LAYER, SOURCE, MOVES = None, "host_clock", None


def read(rec):
    return len(rec.answers) / window_seconds(rec) if rec.answers else None
