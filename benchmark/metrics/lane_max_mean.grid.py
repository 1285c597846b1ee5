"""Max over mean of the lanes' measured cost under the balanced tables
(``Renderer.balance_stats``; the largest over the bands)."""
LAYER, SOURCE, MOVES = "Renderer", "program_counter", "samples_per_s"


def read(rec):
    return rec.counters.get("balance_max_over_mean")
