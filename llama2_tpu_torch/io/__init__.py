import os

from llama2_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint


def load_any(path: str):
    """Load a checkpoint, sniffing the format: a param-cache directory
    (:mod:`.cache`), ak42 v2 (INT8) or v0 fp32.

    Returns ``(config, params, shared)`` with params in the layout of
    :mod:`.checkpoint`; the quantized formats' matmul weights are QuantTensors.
    """
    from llama2_tpu_torch.io.cache import is_cache_dir, load_cache

    if is_cache_dir(path):
        return load_cache(path)
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory but not a param cache (no meta.json)")
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"24ka":  # ak42 v2 magic 0x616b3432, little-endian
        from llama2_tpu_torch.io.quantized import load_quantized_checkpoint

        return load_quantized_checkpoint(path)
    return load_checkpoint(path)


__all__ = ["load_checkpoint", "save_checkpoint", "load_any"]
