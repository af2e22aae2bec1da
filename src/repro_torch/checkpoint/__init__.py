from repro_torch.checkpoint.checkpoint import load_arrays, save_arrays

__all__ = ["load_arrays", "save_arrays"]
