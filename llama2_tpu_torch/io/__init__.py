import os

from llama2_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint


def load_any(path: str):
    """Load a checkpoint, sniffing the format.

    Only the llama2.c v0 fp32 format is ported so far. An ak42 v2 (INT8) file
    and a param-cache directory raise ``NotImplementedError``: they belong to
    the quantized-weight slice of the port. Returns ``(config, params,
    shared)`` with numpy params in the layout of :mod:`.checkpoint`.
    """
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory: param-cache directories are not yet "
            "ported to the torch package (quantized-weight slice)"
        )
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"24ka":  # ak42 v2 magic 0x616b3432, little-endian
        raise NotImplementedError(
            f"{path} is an ak42 INT8 checkpoint: quantized weights are not "
            "yet ported to the torch package (quantized-weight slice)"
        )
    return load_checkpoint(path)


__all__ = ["load_checkpoint", "save_checkpoint", "load_any"]
