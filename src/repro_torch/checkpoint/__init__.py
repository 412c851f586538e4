from repro_torch.checkpoint.ckpt import (checkpoint_step, load_checkpoint,
                                         save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "checkpoint_step"]
