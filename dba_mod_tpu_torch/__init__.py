"""dba_mod_tpu_torch — the PyTorch/CUDA port of dba_mod_tpu.

Runs the federated backdoor-attack (DBA) experiments of the JAX package on an
NVIDIA GPU: the same reference-schema YAML, the same run folder, the same
DBA semantics. The JAX package ``dba_mod_tpu`` is the reference the port is
held against; the port imports nothing from it (and no JAX) — it keeps its
own copies of the modules it needs, under the same module names.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``); asking for CUDA without a card raises.
"""
