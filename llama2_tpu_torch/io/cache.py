"""On-disk param cache: a directory of raw ``.npy`` tensors + ``meta.json``.

Port of ``llama2_tpu/io/cache.py``; a directory written by either package
loads in the other, and both write the same bytes. Converting a llama2.c
``.bin`` costs a full parse + transpose (+ quantize, for INT8) at every start;
the cache stores the final param tree, ``QuantTensor`` leaves as
``<name>.q.npy`` / ``<name>.scale.npy`` pairs, so a restart memory-maps the
files and the first copy of a tensor is the one to its device.

    save_cache(dir, config, params, shared)
    config, params, shared = load_cache(dir)

The generate CLI treats a directory checkpoint path as a cache
(``python -m llama2_tpu_torch model-cache/ ...``) and writes one with
``--save-cache DIR``. The per-host sharded load of the JAX module is not
ported (no tensor parallelism here yet).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from llama2_tpu_torch.config import ModelConfig
from llama2_tpu_torch.quant.q8 import QuantTensor

_META = "meta.json"
FORMAT_VERSION = 1


def _as_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            raise ValueError("a param cache holds fp32 and int8 tensors; save before casting to bf16")
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_cache(path: str, config: ModelConfig, params: dict, shared: bool = False) -> None:
    os.makedirs(path, exist_ok=True)
    meta = {
        "format_version": FORMAT_VERSION,
        "config": dataclasses.asdict(config),
        "shared": shared,  # classifier aliases the embedding (v0 sentinel)
        "tensors": {},
    }
    for name, value in params.items():
        if isinstance(value, QuantTensor):
            np.save(os.path.join(path, f"{name}.q.npy"), _as_numpy(value.q))
            np.save(os.path.join(path, f"{name}.scale.npy"), _as_numpy(value.scale))
            meta["tensors"][name] = {"kind": "q8", "group_size": value.group_size}
        else:
            np.save(os.path.join(path, f"{name}.npy"), _as_numpy(value))
            meta["tensors"][name] = {"kind": "dense"}
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f, indent=1)


def _mmap(path: str) -> np.ndarray:
    # copy-on-write: nothing is read until a page is touched and the file is
    # never written, yet the array is writable, which torch.from_numpy wants
    return np.load(path, mmap_mode="c")


def load_cache(path: str):
    """Returns ``(config, params, shared)``. Dense tensors come back as
    memory-mapped numpy arrays, quantized ones as QuantTensors of CPU tensors
    over the mapped files: no host copy until the transfer to the device
    reads them."""
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported cache version {meta.get('format_version')}")
    config = ModelConfig(**meta["config"])
    params = {}
    for name, info in meta["tensors"].items():
        if info["kind"] == "q8":
            params[name] = QuantTensor(
                q=torch.from_numpy(_mmap(os.path.join(path, f"{name}.q.npy"))),
                scale=torch.from_numpy(_mmap(os.path.join(path, f"{name}.scale.npy"))),
                group_size=info["group_size"],
            )
        else:
            params[name] = _mmap(os.path.join(path, f"{name}.npy"))
    return config, params, bool(meta.get("shared", False))


def is_cache_dir(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, _META))
