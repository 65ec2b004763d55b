"""nomad_tpu_torch — the scheduler's PyTorch/CUDA port.

A second package beside ``nomad_tpu`` (the JAX reference).  The host
control plane (state store, eval broker, plan applier, workers) is a copy
of the reference's; the scheduling math runs as hand-written CUDA kernels
over a card-resident node matrix (``ops/csrc``), with plain PyTorch
versions of the same functions for the CPU (``ops/kernels.py``).

Nothing here imports ``jax`` or ``nomad_tpu``.
"""

__version__ = "0.1.0"
