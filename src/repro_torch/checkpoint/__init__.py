from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, latest_step, read_checkpoint_meta, restore_checkpoint,
    save_checkpoint)
