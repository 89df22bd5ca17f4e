"""The MoE layer: gate, balance metrics, dispatch and fmoe; and ``fmoefy``,
the paper's plugin that turns a dense config into an MoE one."""
from repro_torch.core.fmoefy import fmoefy

__all__ = ["fmoefy"]
