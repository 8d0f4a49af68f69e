from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]
