"""Device selection shared by every entry point of the port.

Entry points take an explicit ``device`` (default ``"cuda"``).  Asking for
the card on a host without one raises: the port never carries on quietly
on the CPU.  Callers that want the CPU (the tests) say ``device="cpu"``.
"""

from __future__ import annotations

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
