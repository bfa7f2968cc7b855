"""Device selection for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card.  The CPU
is used only when the caller asks for it explicitly (the tests do); a
request for CUDA on a machine without a card raises instead of quietly
running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> cuda.  Raises RuntimeError when CUDA is asked for and no card
    is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "winnowmap_tpu_torch: CUDA device requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
