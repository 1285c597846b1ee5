"""``band_imbalance.gpus4``'s quantity, the slowest card's span (its first
operation to its last) over the mean span of the cards in the traced
image, for the cells that report ``samples_per_s.short``."""
from pathlib import Path

from benchmark import metrics

LAYER, SOURCE, MOVES = "Parallel", "device_trace", "samples_per_s.short"


def read(rec):
    return metrics.load("band_imbalance.gpus4", Path(__file__).resolve().parent).read(rec)
