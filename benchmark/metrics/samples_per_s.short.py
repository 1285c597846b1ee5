"""``samples_per_s`` for cells of short images (well under a second), where
the host's work per image and the host's speed weigh, so the bound is
wider."""
from benchmark.metrics import sample_rate

LAYER, SOURCE, MOVES = None, "host_clock", None


def read(rec):
    return sample_rate(rec)
