"""Training: AdamW with the reference's mixed-precision arithmetic,
top-k gradient compression with error feedback, checkpoints and the
fault-tolerant loop."""
from .checkpoint import CheckpointManager
from .compression import (CompressionConfig, compress_grads, compress_init,
                          modeled_wire_bytes)
from .optimizer import (AdamWConfig, adamw_init, adamw_update, global_norm,
                        schedule)
from .runtime import RuntimeConfig, TrainRuntime

__all__ = ["AdamWConfig", "CheckpointManager", "CompressionConfig",
           "RuntimeConfig", "TrainRuntime", "adamw_init", "adamw_update",
           "compress_grads", "compress_init", "global_norm",
           "modeled_wire_bytes", "schedule"]
