"""Device resolution shared by the entry points.

Every entry point takes ``device="cuda"`` by default.  The CPU runs only when
the caller asks for it: nothing falls back to the CPU when CUDA is missing.
The ``meta`` device (shapes only, nothing computed) serves the dry run
(``launch/dryrun``).
"""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``torch.device(device)``, raising when it names CUDA on a host without
    a usable card (never a silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu' "
                         f"('meta' for the dry run)")
    return dev
