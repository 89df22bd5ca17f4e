from repro_torch.optim.adamw import AdamW, AdamWState, global_norm
from repro_torch.optim.schedule import warmup_cosine, warmup_linear

__all__ = ["AdamW", "AdamWState", "global_norm", "warmup_cosine",
           "warmup_linear"]
