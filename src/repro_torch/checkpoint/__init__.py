from .checkpoint import (latest_checkpoint, load_checkpoint, save_checkpoint,
                         save_flat_checkpoint)

__all__ = ["save_checkpoint", "save_flat_checkpoint", "load_checkpoint",
           "latest_checkpoint"]
