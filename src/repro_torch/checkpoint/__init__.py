from repro_torch.checkpoint.checkpoint import (MANIFEST, latest_step, restore_checkpoint,
                                               save_checkpoint, verify_checkpoint)

__all__ = ["MANIFEST", "latest_step", "restore_checkpoint", "save_checkpoint",
           "verify_checkpoint"]
