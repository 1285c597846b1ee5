"""Max over mean of the lanes' measured cost under the bands' balanced
tables (``MultiChipRenderer.balance_stats``; the largest over every band's
tables)."""
LAYER, SOURCE, MOVES = "Renderer", "program_counter", "samples_per_s.short"


def read(rec):
    return rec.counters.get("balance_max_over_mean")
