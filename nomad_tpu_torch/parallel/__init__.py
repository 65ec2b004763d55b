"""Batched-eval input assembly (the port's part of the JAX package's
``parallel/``).  The node-axis sharding over several cards is not here
yet; only the helpers that build a batch for ``score_batch``."""

from .sharding import build_batch_inputs, stack_requests

__all__ = ["build_batch_inputs", "stack_requests"]
