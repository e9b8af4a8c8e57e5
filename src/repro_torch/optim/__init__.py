"""`repro_torch.optim` -- the training optimizers (`optimizers`: AdamW,
Adafactor, the reference's stacked parameter grouping), the learning-rate
schedule (`schedules`) and int8 gradient compression with error feedback
(`grad_compress`). Counterpart of `repro.optim`."""
from repro_torch.optim.optimizers import (
    Group,
    Optimizer,
    adafactor,
    adamw,
    get_optimizer,
    param_groups,
)
from repro_torch.optim.schedules import cosine_schedule

__all__ = ["Group", "Optimizer", "adafactor", "adamw", "cosine_schedule",
           "get_optimizer", "param_groups"]
