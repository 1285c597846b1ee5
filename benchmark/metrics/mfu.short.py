"""The whole traced image's share of the cards' float32 peak: its work
count over the traced window's length times the cards' peak, in percent."""
from benchmark.metrics import mfu

LAYER, SOURCE, MOVES = "Device", "device_trace", "samples_per_s.short"


def read(rec):
    return mfu(rec)
