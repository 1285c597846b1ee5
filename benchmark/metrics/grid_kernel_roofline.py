"""The traced image's work count (``benchmark/workcount.py``) at the card's
float32 peak, over the grid kernel's device time in that image, in
percent.  Bound by operations; ``--fmad=false`` caps it near 50%."""
from benchmark.metrics import roofline

LAYER, SOURCE, MOVES = "Kernels", "device_trace", "samples_per_s"


def read(rec):
    return roofline(rec, "grid_megakernel_step_kernel")
