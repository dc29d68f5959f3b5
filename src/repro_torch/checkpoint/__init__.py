"""Atomic checkpoints of the training state."""

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
