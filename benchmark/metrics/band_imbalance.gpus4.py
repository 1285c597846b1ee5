"""In the traced image, the slowest card's span (its first operation to its
last) over the mean span of the cards."""
LAYER, SOURCE, MOVES = "Parallel", "device_trace", "samples_per_s"


def read(rec):
    if rec.trace is None or len(rec.trace["devices"]) < 2:
        return None
    spans = [d["last_us"] - d["first_us"] for d in rec.trace["devices"].values()]
    return max(spans) / (sum(spans) / len(spans))
