"""The benchmark of sod_tpu_torch on one H100: see BENCHMARK.json and PERF.md."""
