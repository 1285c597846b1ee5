"""From the harness's start (before torch is imported) to the window's
start: imports, the device, the kernels' build or load, the scene, its
tables and upload, the balance probe and the warm-up."""
LAYER, SOURCE, MOVES = None, "host_clock", None


def read(rec):
    return rec.setup_s
