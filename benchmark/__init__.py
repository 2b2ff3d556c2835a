"""The benchmark of ``mendeliht_tpu_torch`` on one NVIDIA H100: one cell
(a configuration under a traffic mix, ``BENCHMARK.json``) a run,
``python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``."""
