"""llama2.c v2 (``ak42``) group-quantized INT8 checkpoint format.

Port of ``llama2_tpu/io/quantized.py``; files written by either package load
in the other, and both savers write the same bytes. Layout:

* 256-byte header: ``u32 magic 0x616b3432`` ("ak42" LE), ``i32 version=2``,
  7 x i32 config, ``u8 shared_classifier``, ``i32 group_size``, zero pad;
* fp32 section: ``rms_att (L,D)``, ``rms_ffn (L,D)``, ``rms_final (D)``;
* quantized tensors, each as ``int8 values`` then ``f32 scales`` (one scale
  per ``group_size`` consecutive values of the flattened row-major tensor):
  ``q_tokens (V,D)``, ``wq (L,D,D)``, ``wk``, ``wv``, ``wo``, ``w1 (L,HD,D)``,
  ``w2 (L,D,HD)``, ``w3``, then ``wcls (V,D)`` only when not shared.

Mapping to the engine layout: matmul weights transpose to (in, out) and
llama2.c's flat groups become in-feature groups, so a (out, in/G) scale
matrix transposes to (in/G, out). The quantized token embedding is
dequantized to fp32 on load (rows are gathered by id; the classifier reuses
the int8 data transposed when shared).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from llama2_tpu_torch.config import ModelConfig
from llama2_tpu_torch.quant.q8 import QuantTensor

MAGIC = 0x616B3432
VERSION = 2
HEADER_SIZE = 256
_HEADER = struct.Struct("<iiiiiiiii")  # magic, version, 7 config ints


def _dequant_flat(q: np.ndarray, scales: np.ndarray, group_size: int) -> np.ndarray:
    flat = q.reshape(-1, group_size).astype(np.float32) * scales[:, None]
    return flat.reshape(q.shape)


def _to_quant_tensor(q: np.ndarray, scales: np.ndarray, group_size: int) -> QuantTensor:
    """(out, in) row-major int8 + flat scales -> an (in, out) QuantTensor."""
    *lead, n_out, n_in = q.shape
    s = scales.reshape(*lead, n_out, n_in // group_size)
    return QuantTensor(
        q=torch.from_numpy(np.ascontiguousarray(np.swapaxes(q, -1, -2))),
        scale=torch.from_numpy(np.ascontiguousarray(np.swapaxes(s, -1, -2))),
        group_size=group_size,
    )


def load_quantized_checkpoint(path: str):
    """Read an ak42 v2 checkpoint -> (config, params, shared). Matmul weights
    come back as QuantTensors of CPU tensors; norms and embedding as fp32
    numpy arrays."""
    with open(path, "rb") as f:
        head = f.read(HEADER_SIZE)
        if len(head) < HEADER_SIZE:
            raise ValueError(f"checkpoint too short for v2 header: {path}")
        magic, version, dim, hidden, n_layers, n_heads, n_kv_heads, vocab, seq_len = (
            _HEADER.unpack_from(head, 0)
        )
        if magic != MAGIC:
            raise ValueError(f"bad magic {magic:#x}; not an ak42 checkpoint")
        if version != VERSION:
            raise ValueError(f"unsupported ak42 version {version}")
        shared = bool(head[_HEADER.size])
        (group_size,) = struct.unpack_from("<i", head, _HEADER.size + 1)
        config = ModelConfig(
            dim=dim, hidden_dim=hidden, n_layers=n_layers, n_heads=n_heads,
            n_kv_heads=n_kv_heads, vocab_size=vocab, seq_len=seq_len,
        )
        body = np.fromfile(f, dtype=np.uint8)

    L, D, HD, V = n_layers, dim, hidden, vocab
    KV = config.kv_dim
    off = 0

    def take_f32(*shape):
        nonlocal off
        n = int(np.prod(shape))
        out = body[off : off + 4 * n].view("<f4").reshape(shape)
        off += 4 * n
        return out

    def take_q(*shape):
        nonlocal off
        n = int(np.prod(shape))
        q = body[off : off + n].view(np.int8).reshape(shape)
        off += n
        s = body[off : off + 4 * (n // group_size)].view("<f4").copy()
        off += 4 * (n // group_size)
        return q, s

    rms_att = take_f32(L, D).copy()
    rms_ffn = take_f32(L, D).copy()
    rms_final = take_f32(D).copy()

    q_tok, s_tok = take_q(V, D)
    params = {
        "tok_emb": _dequant_flat(q_tok, s_tok, group_size),
        "rms_att": rms_att,
        "rms_ffn": rms_ffn,
        "rms_final": rms_final,
    }
    for name, shape in (
        ("wq", (L, D, D)), ("wk", (L, KV, D)), ("wv", (L, KV, D)),
        ("wo", (L, D, D)), ("w1", (L, HD, D)), ("w2", (L, D, HD)),
        ("w3", (L, HD, D)),
    ):
        q, s = take_q(*shape)
        params[name] = _to_quant_tensor(q, s, group_size)

    if shared:
        # the classifier reuses the embedding's int8 data: (V, D) -> (D, V)
        params["wcls"] = _to_quant_tensor(q_tok, s_tok, group_size)
    else:
        q, s = take_q(V, D)
        params["wcls"] = _to_quant_tensor(q, s, group_size)
    if off > body.size:
        raise ValueError("v2 checkpoint truncated")
    return config, params, shared


def save_quantized_checkpoint(
    path: str, config: ModelConfig, params: dict, shared: bool, group_size: int
) -> None:
    """Write ak42 v2 from a param tree (QuantTensors for the matmul weights,
    the fp32 ``tok_emb`` re-quantized flat like llama2.c's export)."""
    head = bytearray(HEADER_SIZE)
    _HEADER.pack_into(
        head, 0, MAGIC, VERSION, config.dim, config.hidden_dim, config.n_layers,
        config.n_heads, config.n_kv_heads, config.vocab_size, config.seq_len,
    )
    head[_HEADER.size] = 1 if shared else 0
    struct.pack_into("<i", head, _HEADER.size + 1, group_size)

    def as_numpy(a) -> np.ndarray:
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    def quant_flat(w: np.ndarray):
        flat = np.asarray(w, np.float32).reshape(-1, group_size)
        scale = np.abs(flat).max(axis=1) / 127.0
        safe = np.where(scale == 0, 1.0, scale)
        q = np.rint(flat / safe[:, None]).astype(np.int8)
        return q.reshape(w.shape), scale.astype("<f4")

    def from_quant_tensor(t: QuantTensor):
        if t.group_size != group_size:
            raise ValueError(
                f"tensor group size {t.group_size} != file group size {group_size}"
            )
        q = np.swapaxes(as_numpy(t.q), -1, -2)  # back to (out, in)
        s = np.swapaxes(as_numpy(t.scale), -1, -2)
        return np.ascontiguousarray(q), np.ascontiguousarray(s).reshape(-1)

    with open(path, "wb") as f:
        f.write(head)
        np.asarray(as_numpy(params["rms_att"]), "<f4").tofile(f)
        np.asarray(as_numpy(params["rms_ffn"]), "<f4").tofile(f)
        np.asarray(as_numpy(params["rms_final"]), "<f4").tofile(f)

        q_tok, s_tok = quant_flat(as_numpy(params["tok_emb"]))
        q_tok.tofile(f)
        s_tok.tofile(f)

        names = ["wq", "wk", "wv", "wo", "w1", "w2", "w3"] + ([] if shared else ["wcls"])
        for name in names:
            q, s = from_quant_tensor(params[name])
            q.astype(np.int8).tofile(f)
            np.asarray(s, "<f4").tofile(f)
