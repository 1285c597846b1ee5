"""The traced sub-window's share in which no operation ran on the card."""
from benchmark.metrics import idle_share

LAYER, SOURCE, MOVES = "Device", "device_trace", "frame_ms_p95"


def read(rec):
    return idle_share(rec)
