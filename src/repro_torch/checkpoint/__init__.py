from repro_torch.checkpoint.manager import LSTCheckpointManager, leaf_paths

__all__ = ["LSTCheckpointManager", "leaf_paths"]
