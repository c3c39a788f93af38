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


def is_quantized(path: str) -> bool:
    """Whether the checkpoint at ``path`` stores its matmul weights as Q8
    already: a param-cache directory of QuantTensors, or an ak42 v2 file."""
    import json

    from llama2_tpu_torch.io.cache import is_cache_dir

    if is_cache_dir(path):
        with open(os.path.join(path, "meta.json")) as f:
            return json.load(f)["tensors"].get("wq", {}).get("kind") == "q8"
    if not os.path.isfile(path):
        return False
    with open(path, "rb") as f:
        return f.read(4) == b"24ka"


__all__ = ["load_checkpoint", "save_checkpoint", "load_any", "is_quantized"]
