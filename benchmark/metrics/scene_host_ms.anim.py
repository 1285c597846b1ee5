"""Median per frame of the host time in ``generate_random_scene(t)`` and
``Renderer.set_scene`` (the benchmark's spans)."""
import statistics

LAYER, SOURCE, MOVES = "Frame loop", "program_span", "frame_ms_p95"


def read(rec):
    gen, put = rec.spans.get("scene_gen", []), rec.spans.get("set_scene", [])
    if not gen or len(gen) != len(put):
        return None
    return statistics.median((a + b) * 1e3 for a, b in zip(gen, put))
