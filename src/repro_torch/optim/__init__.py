from .adamw import (AdamWConfig, OptState, adamw_init, adamw_update,  # noqa: F401
                    clip_by_global_norm, global_norm, warmup_cosine)
