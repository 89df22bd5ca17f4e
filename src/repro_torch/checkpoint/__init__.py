from repro_torch.checkpoint.ckpt import (CheckpointError, complete_steps,
                                         gc_checkpoints, is_complete,
                                         latest_step, load_manifest, restore,
                                         save, step_path)

__all__ = ["CheckpointError", "complete_steps", "gc_checkpoints",
           "is_complete", "latest_step", "load_manifest", "restore", "save",
           "step_path"]
