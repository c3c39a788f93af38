"""Weight-only group-quantized INT8 (Q8_0), the llama2.c ``runq`` lineage.

Port of ``llama2_tpu/quant/q8.py``: symmetric int8 with one fp32 scale per
group of ``group_size`` consecutive elements along the **contraction
(in-features) axis**, ``scale = max|x| / 127``, no zero point. ``quantize``
runs in numpy with the same operations as the JAX package, so both give the
same int8 and scale bytes for the same input.

The matmul contract: ``x (.., in) @ W -> (.., out)`` where W dequantizes to
``q.reshape(in/G, G, out) * scale[:, None, :]``. ``backend="torch"`` writes
the dequantize beside ``torch.matmul``; the CUDA backends stream the int8
weights through the hand-written dequant-matmul kernel
(``ops/cuda/quant_matmul.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_GROUP_SIZE = 64  # llama2.c runq default


@dataclasses.dataclass
class QuantTensor:
    """int8 values + per-group fp32 scales; groups along the in-features axis.

    ``q``: int8, shape (..., in, out), the shape of the fp original.
    ``scale``: f32, shape (..., in/G, out). It stays float32 whatever the
    activation dtype is.
    """

    q: torch.Tensor
    scale: torch.Tensor
    group_size: int

    @property
    def shape(self):
        return self.q.shape

    @property
    def device(self):
        return self.q.device

    def to(self, device) -> "QuantTensor":
        return QuantTensor(self.q.to(device), self.scale.to(device), self.group_size)

    def __getitem__(self, index) -> "QuantTensor":
        """Index leading (layer) axes, never the last two."""
        return QuantTensor(self.q[index], self.scale[index], self.group_size)


def quantize(w, group_size: int = DEFAULT_GROUP_SIZE) -> QuantTensor:
    """Group-quantize along axis -2 (in-features). Shape (..., in, out)."""
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    w = np.asarray(w, dtype=np.float32)
    *lead, n_in, n_out = w.shape
    if n_in % group_size != 0:
        raise ValueError(f"in-features {n_in} not divisible by group size {group_size}")
    g = w.reshape(*lead, n_in // group_size, group_size, n_out)
    absmax = np.max(np.abs(g), axis=-2)  # (..., in/G, out)
    scale = absmax / 127.0
    safe = np.where(scale == 0.0, 1.0, scale)
    # ties-to-even, as the JAX package (llama2.c's roundf differs on exact .5)
    q = np.rint(g / safe[..., None, :]).astype(np.int8)
    return QuantTensor(
        q=torch.from_numpy(np.ascontiguousarray(q.reshape(w.shape))),
        scale=torch.from_numpy(np.ascontiguousarray(scale, dtype=np.float32)),
        group_size=group_size,
    )


def dequantize(t: QuantTensor, dtype=torch.float32) -> torch.Tensor:
    *lead, n_in, n_out = t.q.shape
    g = t.q.reshape(*lead, n_in // t.group_size, t.group_size, n_out)
    w = g.to(t.scale.dtype) * t.scale[..., None, :]
    return w.reshape(t.q.shape).to(dtype)


QUANTIZED_PARAMS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "wcls")


def quantize_params(
    params: dict, group_size: int = DEFAULT_GROUP_SIZE, keys=QUANTIZED_PARAMS
) -> dict:
    """Quantize the matmul weights; norms and the embedding stay fp. A tensor
    whose in-features the group size does not divide takes their gcd."""
    out = dict(params)
    for k in keys:
        n_in = params[k].shape[-2]
        gs = group_size if n_in % group_size == 0 else int(np.gcd(n_in, group_size))
        out[k] = quantize(params[k], gs)
    return out
