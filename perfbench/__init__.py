"""The benchmark of dba_mod_tpu_torch on NVIDIA cards (BENCHMARK.json).

It measures the PyTorch port only, and loads neither JAX nor the JAX
package. ``python3 -m perfbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` runs one cell once."""
