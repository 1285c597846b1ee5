"""The traced image's work count (``benchmark/workcount.py``) at the card's
float32 peak, over the paged kernel's device time in that image, in
percent.  Bound by operations; ``--fmad=false`` caps it near 50%."""
from benchmark.metrics import roofline

LAYER, SOURCE, MOVES = "Kernels", "device_trace", "samples_per_s.short"


def read(rec):
    return roofline(rec, "paged_megakernel_step_kernel")
