"""The 95th percentile (nearest rank) of every frame's time in the window,
from the start of its scene generation to its u8 image on the host."""
import math

LAYER, SOURCE, MOVES = None, "host_clock", None


def read(rec):
    if not rec.answers:
        return None
    ms = sorted((a["end"] - a["start"]) * 1e3 for a in rec.answers)
    return ms[max(0, math.ceil(0.95 * len(ms)) - 1)]
