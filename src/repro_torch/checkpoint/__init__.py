"""`repro_torch.checkpoint` -- atomic, async checkpoints of a training
state (`checkpoint`). Counterpart of `repro.checkpoint`."""
from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    latest_step,
    restore,
    save,
)

__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
