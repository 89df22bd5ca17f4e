"""repro_torch: the FastMoE system ported to PyTorch and CUDA for one H100.

A package beside the JAX reference ``repro``: it mirrors its module names,
imports ``torch``, numpy and the standard library only, and runs every
kernel of its path as a hand-written CUDA kernel for Hopper (``sm_90a``).
Entry points run on ``device="cuda"`` unless the caller passes ``"cpu"``.
"""
__version__ = "0.1.0"

from repro_torch.core.fmoefy import fmoefy  # noqa: E402,F401
