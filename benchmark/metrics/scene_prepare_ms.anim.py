"""Median host time of ``prepare_scene`` in ms: the sphere table and the
grid or paged tables built on the host, inside ``Renderer.set_scene`` (the
program's ``scene.prepare`` spans)."""
import statistics

LAYER, SOURCE, MOVES = "Renderer", "program_span", "frame_ms_p95"


def read(rec):
    try:
        from raytrace_tpu_torch.ops.launches import records
    except ImportError:  # a program without spans
        return None
    ms = [(r.t1 - r.t0) * 1e3 for r in records(rec.window_start, rec.window_end)
          if r.name == "scene.prepare"]
    return statistics.median(ms) if ms else None
