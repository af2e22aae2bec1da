from repro_torch.checkpoint.checkpoint import (load_arrays, restore_checkpoint,
                                               save_arrays, save_checkpoint,
                                               tree_paths)

__all__ = ["load_arrays", "restore_checkpoint", "save_arrays",
           "save_checkpoint", "tree_paths"]
