from .checkpoint import CheckpointManager
