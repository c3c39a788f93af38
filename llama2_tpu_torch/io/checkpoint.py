"""llama2.c v0 ``.bin`` checkpoint reader/writer.

Byte-exact implementation of the format the reference parses at
main.zig:936-967 (header) and main.zig:85-112 (weight order):

1. Header: 7 x i32 little-endian: ``dim, hidden_dim, n_layers, n_heads,
   n_kv_heads, vocab_size, seq_len``. A **negative** ``vocab_size`` signals an
   unshared classifier matrix; its absolute value is the real vocab size
   (main.zig:942-944).
2. Body: contiguous fp32 LE tensors, in order: ``token_embedding (V,D)``,
   ``rms_att (L,D)``, ``wq (L, D_out=H*hs, D_in=D)``, ``wk (L, KV, D)``,
   ``wv (L, KV, D)``, ``wo (L, D, D)``, ``rms_ffn (L,D)``, ``w1 (L, HD, D)``,
   ``w2 (L, D, HD)``, ``w3 (L, HD, D)``, ``rms_final (D,)``,
   ``freq_cis_real (S, hs/2)``, ``freq_cis_imag (S, hs/2)`` (both *skipped* —
   RoPE is recomputed on the fly, main.zig:67 and 298-300), then ``wcls (V,D)``
   only when unshared.

All matmul weights are row-major out-features-major, computing ``W(d,n) @ x(n)``
(main.zig:470-483). The engine computes activations as row vectors
(``x @ W``), so every matmul weight is **transposed on load** to
``(in_features, out_features)`` and per-layer weights are stacked along a
leading layer axis. A numpy-only copy of ``llama2_tpu/io/checkpoint.py``, in
the same layout, so both packages read the same parameter dict.

Param tree layout (all numpy float32 unless converted later):

    tok_emb    (V, D)        — embedding table, also the classifier when shared
    rms_att    (L, D)
    wq         (L, D, D)
    wk         (L, D, KV)
    wv         (L, D, KV)
    wo         (L, D, D)
    rms_ffn    (L, D)
    w1         (L, D, HD)
    w2         (L, HD, D)
    w3         (L, D, HD)
    rms_final  (D,)
    wcls       (D, V)        — always present; transpose of tok_emb when shared
"""

from __future__ import annotations

import struct

import numpy as np

from llama2_tpu_torch.config import ModelConfig

_HEADER_STRUCT = struct.Struct("<7i")


def _take(buf: np.ndarray, offset: int, shape: tuple[int, ...]):
    n = int(np.prod(shape))
    view = buf[offset : offset + n].reshape(shape)
    return view, offset + n


def load_checkpoint(path: str) -> tuple[ModelConfig, dict, bool]:
    """Read a llama2.c v0 checkpoint.

    Returns ``(config, params, shared_weights)``. ``params`` is the dict
    documented in the module docstring; arrays are copies (C-contiguous) so the
    file buffer can be freed.
    """
    with open(path, "rb") as f:
        header = f.read(_HEADER_STRUCT.size)
        if len(header) != _HEADER_STRUCT.size:
            raise ValueError(f"checkpoint too short for header: {path}")
        dim, hidden_dim, n_layers, n_heads, n_kv_heads, vocab_size, seq_len = (
            _HEADER_STRUCT.unpack(header)
        )
        shared_weights = vocab_size > 0
        vocab_size = abs(vocab_size)
        config = ModelConfig(
            dim=dim,
            hidden_dim=hidden_dim,
            n_layers=n_layers,
            n_heads=n_heads,
            n_kv_heads=n_kv_heads,
            vocab_size=vocab_size,
            seq_len=seq_len,
        )
        buf = np.fromfile(f, dtype="<f4")

    hs = config.head_size
    kv = config.kv_dim
    L, D, HD, V, S = n_layers, dim, hidden_dim, vocab_size, seq_len

    # Up-front size check: a mid-weights truncation would otherwise surface
    # as an opaque reshape error from _take, never the message below.
    expected = (
        V * D + L * D + L * D * D + 2 * L * kv * D + L * D * D + L * D
        + 3 * L * HD * D + D + 2 * S * (hs // 2)
        + (0 if shared_weights else V * D)
    )
    if buf.size < expected:
        raise ValueError(
            f"checkpoint truncated: needed {expected} floats, file has "
            f"{buf.size} ({path})"
        )

    off = 0
    tok_emb, off = _take(buf, off, (V, D))
    rms_att, off = _take(buf, off, (L, D))
    wq, off = _take(buf, off, (L, D, D))
    wk, off = _take(buf, off, (L, kv, D))
    wv, off = _take(buf, off, (L, kv, D))
    wo, off = _take(buf, off, (L, D, D))
    rms_ffn, off = _take(buf, off, (L, D))
    w1, off = _take(buf, off, (L, HD, D))
    w2, off = _take(buf, off, (L, D, HD))
    w3, off = _take(buf, off, (L, HD, D))
    rms_final, off = _take(buf, off, (D,))
    # freq_cis_real/imag are present in the file but unused (main.zig:67).
    off += S * (hs // 2)
    off += S * (hs // 2)
    if shared_weights:
        wcls = tok_emb
    else:
        wcls, off = _take(buf, off, (V, D))
    if off > buf.size:
        raise ValueError(
            f"checkpoint truncated: needed {off} floats, file has {buf.size}"
        )

    params = {
        "tok_emb": np.ascontiguousarray(tok_emb),
        "rms_att": np.ascontiguousarray(rms_att),
        "wq": np.ascontiguousarray(wq.transpose(0, 2, 1)),
        "wk": np.ascontiguousarray(wk.transpose(0, 2, 1)),
        "wv": np.ascontiguousarray(wv.transpose(0, 2, 1)),
        "wo": np.ascontiguousarray(wo.transpose(0, 2, 1)),
        "rms_ffn": np.ascontiguousarray(rms_ffn),
        "w1": np.ascontiguousarray(w1.transpose(0, 2, 1)),
        "w2": np.ascontiguousarray(w2.transpose(0, 2, 1)),
        "w3": np.ascontiguousarray(w3.transpose(0, 2, 1)),
        "rms_final": np.ascontiguousarray(rms_final),
        "wcls": np.ascontiguousarray(wcls.T),
    }
    return config, params, shared_weights


def save_checkpoint(
    path: str, config: ModelConfig, params: dict, shared_weights: bool = True
) -> None:
    """Write a llama2.c v0 checkpoint from a param tree in our layout.

    Inverse of :func:`load_checkpoint`; used by tests and by
    ``chip_smoke.py`` for its CLI checkpoint. ``freq_cis`` tensors are written with their true
    values (``cos/sin(pos * 10000^(-2j/hs))``) for fidelity with llama2.c
    exports, even though readers skip them.
    """
    hs = config.head_size
    S = config.seq_len
    j = np.arange(0, hs, 2, dtype=np.float32) / hs
    freqs = 1.0 / (10000.0**j)  # (hs/2,)
    angles = np.arange(S, dtype=np.float32)[:, None] * freqs[None, :]
    vocab_field = config.vocab_size if shared_weights else -config.vocab_size

    with open(path, "wb") as f:
        f.write(
            _HEADER_STRUCT.pack(
                config.dim,
                config.hidden_dim,
                config.n_layers,
                config.n_heads,
                config.n_kv_heads,
                vocab_field,
                config.seq_len,
            )
        )

        def put(a: np.ndarray):
            np.asarray(a, dtype="<f4").tofile(f)

        put(params["tok_emb"])
        put(params["rms_att"])
        put(params["wq"].transpose(0, 2, 1))
        put(params["wk"].transpose(0, 2, 1))
        put(params["wv"].transpose(0, 2, 1))
        put(params["wo"].transpose(0, 2, 1))
        put(params["rms_ffn"])
        put(params["w1"].transpose(0, 2, 1))
        put(params["w2"].transpose(0, 2, 1))
        put(params["w3"].transpose(0, 2, 1))
        put(params["rms_final"])
        put(np.cos(angles))
        put(np.sin(angles))
        if not shared_weights:
            put(params["wcls"].T)
