"""Training checkpoints of the port (``CheckpointManager``)."""

from tpucap_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
