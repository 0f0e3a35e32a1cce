"""The benchmark of cluster_anywhere_tpu_torch on one NVIDIA H100.

`python -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once and prints one JSON line.  Everything a
cell needs is found by name: its configuration in `configs/<config>.json`, its
traffic in `traffic/<mix>.json` (whose `kind` names the driver in
`cells/<kind>.py`), and each per-layer metric's reader in
`metrics/<metric>.py`.  The yardstick lives here too: the traffic generator,
the operation and byte counts, the peaks, the profiler reduction, and the
plain fp32 reference that decides `correct`.
"""
