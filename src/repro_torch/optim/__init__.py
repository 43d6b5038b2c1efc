from .adamw import OptHParams, adamw_init, adamw_update, global_norm, warmup_cosine

__all__ = ["OptHParams", "adamw_init", "adamw_update", "global_norm", "warmup_cosine"]
