"""AdamW, learning-rate schedules and int8 gradient compression.  Port of
``src/repro/optim``."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
)
from repro_torch.optim.compression import int8_compress, int8_decompress
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "global_norm",
    "cosine_schedule", "linear_warmup_cosine",
    "int8_compress", "int8_decompress",
]
