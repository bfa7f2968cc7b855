"""Batched mapping entry point (reference mm_map over a batch of reads,
src/map.c:279-981): the native engine on the host, every exported
extension-DP job on the device."""
from __future__ import annotations

from ..device import resolve_device
from .engine import STATS, map_batch_engine

__all__ = ["map_batch", "STATS"]


def map_batch(mi, opt, seqs, qnames, device=None):
    """Map a batch of reads; returns one MapResult per read, in order.

    device=None runs the DP on the CUDA card (raises when there is none);
    device="cpu" runs the kernels' plain PyTorch versions.  Options whose
    DP needs a kernel that is not ported yet raise NotImplementedError."""
    return map_batch_engine(mi, opt, seqs, qnames, resolve_device(device))
