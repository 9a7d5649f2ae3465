"""The port's benchmark: ``python3 -m portbench.run --workload <name>
--seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json`` once and prints one JSON line."""
