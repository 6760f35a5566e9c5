"""The benchmark of ``hex_gym_env_tpu_torch`` on one NVIDIA H100: run a cell
with ``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``; ``BENCHMARK.json`` at the checkout's root lists the cells."""
