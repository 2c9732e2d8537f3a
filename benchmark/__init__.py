"""The benchmark of kubernetes_tpu_torch: see run.py and BENCHMARK.json."""
