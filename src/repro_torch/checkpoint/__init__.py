from .checkpointer import Checkpointer, save_checkpoint, restore_checkpoint

__all__ = ["Checkpointer", "save_checkpoint", "restore_checkpoint"]
