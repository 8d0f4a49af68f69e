from .optimizers import (adafactor, adam, adamw, momentum, sgd,
                         cosine_schedule, warmup_cosine, apply_updates,
                         global_norm, clip_by_global_norm, OPTIMIZERS)

__all__ = ["sgd", "momentum", "adam", "adamw", "adafactor",
           "cosine_schedule", "warmup_cosine", "apply_updates",
           "global_norm", "clip_by_global_norm", "OPTIMIZERS"]
