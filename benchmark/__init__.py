"""The benchmark of `densesurfelmapping_tpu_torch` on one H100.

`python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once, from the root of a
checkout.  See `harness.py` for how a cell's files are found by name.
"""
