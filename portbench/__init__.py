"""The benchmark of findtextcenternet_tpu_torch on an NVIDIA H100: run one
cell with ``python3 portbench/run.py --workload <name> --seed <n> --seconds
<s> --trace <0|1>`` from the root of a checkout (BENCHMARK.json)."""
