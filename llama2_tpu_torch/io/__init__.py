import os

from llama2_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint


def load_any(path: str):
    """Load a checkpoint, sniffing the format: ak42 v2 (INT8) or v0 fp32.

    Returns ``(config, params, shared)`` with params in the layout of
    :mod:`.checkpoint`; an ak42 file's matmul weights are QuantTensors. A
    param-cache directory (``llama2_tpu/io/cache.py``) is not ported yet and
    raises ``NotImplementedError``.
    """
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory: param-cache directories are not yet "
            "ported to the torch package"
        )
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"24ka":  # ak42 v2 magic 0x616b3432, little-endian
        from llama2_tpu_torch.io.quantized import load_quantized_checkpoint

        return load_quantized_checkpoint(path)
    return load_checkpoint(path)


__all__ = ["load_checkpoint", "save_checkpoint", "load_any"]
