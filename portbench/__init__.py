"""portbench: the benchmark of sprintz_tpu_torch on an NVIDIA GPU.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
