"""repro_torch.checkpoint — atomic, device-agnostic checkpointing."""

from repro_torch.checkpoint.checkpointer import (Checkpointer, restore_pytree,
                                                 save_pytree)

__all__ = ["Checkpointer", "restore_pytree", "save_pytree"]
