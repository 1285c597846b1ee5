"""The traced image's share in which no operation ran on a card (the mean
over the cards)."""
from benchmark.metrics import idle_share

LAYER, SOURCE, MOVES = "Device", "device_trace", "samples_per_s"


def read(rec):
    return idle_share(rec)
