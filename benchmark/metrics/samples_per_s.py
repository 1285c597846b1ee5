"""Pixel-samples of the whole images completed in the window, over the time
from the window's start to the end of the last of them."""
from benchmark.metrics import sample_rate

LAYER, SOURCE, MOVES = None, "host_clock", None


def read(rec):
    return sample_rate(rec)
