"""The benchmark of fairdiff_torch: `python -m benchmark.run --workload <name>
--seed <n> --seconds <s> --trace <0|1>` runs one cell of BENCHMARK.json."""
