"""The benchmark of ``raytrace_tpu_torch``: one cell of ``BENCHMARK.json``
per run (``python -m benchmark.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``).  Configurations, traffic mixes and metric readers are
files found by name; nothing here imports JAX or the JAX package."""
