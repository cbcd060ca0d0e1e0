"""The benchmark harness of competesmoe_tpu_torch: one run of one cell
(`main.main`), driven by BENCHMARK.json and the files it names."""
