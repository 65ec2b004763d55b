"""Device selection shared by every entry point of the port.

Entry points take an explicit ``device`` (default ``"cuda"``).  Asking for
the card on a host without one raises: the port never carries on quietly
on the CPU.  Callers that want the CPU (the tests) say ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises ``RuntimeError`` for a
    CUDA device when no card is visible, and for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {device!r}")
    return dev


def upload(a, dev: torch.device) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) as a contiguous tensor on
    ``dev``.  To a card it travels through a page-locked copy, so the
    upload only enqueues: from pageable memory an upload of MiBs waits for
    every launch queued before it, and a stuck stream would stall the
    caller outside the dispatch watchdog.  The copy also frees the
    caller's staging buffer at once; torch's caching host allocator
    reuses a page-locked block only after its upload.  On the CPU the
    result may share the array's memory."""
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(
        a, np.ndarray) else a.contiguous()
    if dev.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)
