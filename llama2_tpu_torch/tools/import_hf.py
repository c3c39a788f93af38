"""Import a Hugging Face Llama checkpoint into this engine's formats.

Port of ``llama2_tpu/tools/import_hf.py``: read a ``LlamaForCausalLM``
directory already on disk (``config.json`` plus ``*.safetensors`` shards or
``pytorch_model*.bin``) and write either a v0 ``.bin`` (fp32) or the
fast-load param-cache directory, optionally INT8. A host tool: no device,
and neither ``transformers`` nor ``safetensors`` is needed (the safetensors
reader below is numpy).

    python -m llama2_tpu_torch.tools.import_hf <hf_dir> out.bin
    python -m llama2_tpu_torch.tools.import_hf <hf_dir> out-cache/ --cache [--int8]

Weight mapping (HF -> engine layout, all matmuls transposed to
(in_features, out_features) — HF nn.Linear stores (out, in)):

    model.embed_tokens.weight           -> tok_emb         (V, D)
    layers.N.input_layernorm            -> rms_att[N]      (D,)
    layers.N.self_attn.{q,k,v,o}_proj   -> wq/wk/wv/wo[N]  (D, *) transposed
    layers.N.post_attention_layernorm   -> rms_ffn[N]      (D,)
    layers.N.mlp.{gate,down,up}_proj    -> w1/w2/w3[N]     transposed
    model.norm.weight                   -> rms_final       (D,)
    lm_head.weight                      -> wcls            (D, V) transposed
                                           (aliases tok_emb.T when tied)

RoPE: HF Llama rotates halves ("rotate_half") where this engine and llama2.c
rotate interleaved pairs; the difference is a fixed permutation of the head
dimension of wq/wk, which :func:`_unpermute` undoes, so the interleaved
kernels reproduce HF's logits.
"""

from __future__ import annotations

import glob
import json
import os
import struct
import sys

import numpy as np
import torch

from llama2_tpu_torch.config import ModelConfig
from llama2_tpu_torch.io.checkpoint import transposed


def _unpermute(w: np.ndarray, n_heads: int, dim_out: int) -> np.ndarray:
    """Invert HF's rotate_half head-dim permutation of a q/k projection:
    each head's out rows go from (hs/2, 2) order back to (2, hs/2). ``w`` is
    in HF's layout (out=dim_out, in=D)."""
    hs = dim_out // n_heads
    return (
        w.reshape(n_heads, 2, hs // 2, -1)
        .transpose(0, 2, 1, 3)
        .reshape(dim_out, -1)
    )


def import_hf(hf_dir: str) -> tuple[ModelConfig, dict, bool]:
    """Read a HF Llama model directory; returns (config, params, shared)."""
    with open(os.path.join(hf_dir, "config.json")) as f:
        hf = json.load(f)
    if hf.get("model_type") not in (None, "llama"):
        raise ValueError(f"not a llama checkpoint: model_type={hf.get('model_type')}")

    config = ModelConfig(
        dim=hf["hidden_size"],
        hidden_dim=hf["intermediate_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        vocab_size=hf["vocab_size"],
        seq_len=hf.get("max_position_embeddings", 2048),
        norm_eps=hf.get("rms_norm_eps", 1e-5),
    )

    sd = _load_state_dict(hf_dir)

    def g(name):
        return np.asarray(sd[name], dtype=np.float32)

    L = config.n_layers
    H, KVH, hs = config.n_heads, config.n_kv_heads, config.head_size
    p = "model."

    def stack(fn):
        return np.stack([fn(i) for i in range(L)])

    def stack_t(fn):
        """(L, in, out) from the layers' HF (out, in) matrices ``fn(i)``."""
        return transposed(stack(fn))

    params: dict = {
        "tok_emb": g(p + "embed_tokens.weight"),
        "rms_final": g(p + "norm.weight"),
        "rms_att": stack(lambda i: g(f"{p}layers.{i}.input_layernorm.weight")),
        "rms_ffn": stack(lambda i: g(f"{p}layers.{i}.post_attention_layernorm.weight")),
        "wq": stack_t(lambda i: _unpermute(g(f"{p}layers.{i}.self_attn.q_proj.weight"), H, H * hs)),
        "wk": stack_t(lambda i: _unpermute(g(f"{p}layers.{i}.self_attn.k_proj.weight"), KVH, KVH * hs)),
        "wv": stack_t(lambda i: g(f"{p}layers.{i}.self_attn.v_proj.weight")),
        "wo": stack_t(lambda i: g(f"{p}layers.{i}.self_attn.o_proj.weight")),
        "w1": stack_t(lambda i: g(f"{p}layers.{i}.mlp.gate_proj.weight")),
        "w2": stack_t(lambda i: g(f"{p}layers.{i}.mlp.down_proj.weight")),
        "w3": stack_t(lambda i: g(f"{p}layers.{i}.mlp.up_proj.weight")),
    }
    shared = hf.get("tie_word_embeddings", False) or "lm_head.weight" not in sd
    params["wcls"] = transposed(params["tok_emb"] if shared else g("lm_head.weight"))
    params = {k: np.ascontiguousarray(v) for k, v in params.items()}
    return config, params, shared


# safetensors dtype -> numpy little-endian dtype; BF16 is widened below
_ST_DTYPES = {"F32": "<f4", "F16": "<f2", "BF16": "<u2"}


def load_safetensors(path: str) -> dict[str, np.ndarray]:
    """Every tensor of one ``.safetensors`` file as a numpy array: an 8-byte
    little-endian header length, the JSON header (``dtype``, ``shape``,
    ``data_offsets`` into the data that follows it; ``__metadata__``
    skipped), then the data. F32 and F16 keep their dtype; BF16 becomes
    float32 exactly (its 16 bits are a float32's upper half). Any other dtype
    raises."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = np.fromfile(f, dtype=np.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = info["dtype"]
        if dtype not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {dtype}; the importer reads F32, F16 and BF16")
        start, end = info["data_offsets"]
        a = data[start:end].view(_ST_DTYPES[dtype])
        if dtype == "BF16":  # widened by torch's cast: the bits become a float32's upper half
            a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).float().numpy()
        out[name] = a.reshape(info["shape"])
    return out


def _load_state_dict(hf_dir: str) -> dict:
    """Load weights from safetensors shards or a torch ``.bin`` state dict."""
    st = sorted(glob.glob(os.path.join(hf_dir, "*.safetensors")))
    if st:
        sd: dict = {}
        for shard in st:
            sd.update(load_safetensors(shard))
        return sd
    bins = sorted(glob.glob(os.path.join(hf_dir, "pytorch_model*.bin")))
    if not bins:
        raise FileNotFoundError(f"no weights (*.safetensors / pytorch_model*.bin) in {hf_dir}")
    sd = {}
    for shard in bins:
        part = torch.load(shard, map_location="cpu", weights_only=True)
        sd.update({k: v.float().numpy() for k, v in part.items()})
    return sd


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cache = "--cache" in argv
    int8 = "--int8" in argv
    argv = [a for a in argv if a not in ("--cache", "--int8")]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    src, dst = argv
    if int8 and not cache:
        print("--int8 requires --cache (v0 .bin is fp32)", file=sys.stderr)
        return 1
    config, params, shared = import_hf(src)
    print(f"imported: {config} shared_weights={shared}")
    if cache:
        if int8:
            from llama2_tpu_torch.quant.q8 import quantize_params

            # as tensors: torch's quantizer, the numpy one's bytes
            params = quantize_params({k: torch.from_numpy(v) for k, v in params.items()})
        from llama2_tpu_torch.io.cache import save_cache

        save_cache(dst, config, params, shared)
    else:
        if config.norm_eps != 1e-5:
            print(
                f"warning: v0 .bin cannot store rms_norm_eps={config.norm_eps}"
                " (format has no field; loaders will use 1e-5). Use --cache"
                " to preserve it.",
                file=sys.stderr,
            )
        from llama2_tpu_torch.io.checkpoint import save_checkpoint

        save_checkpoint(dst, config, params, shared)
    print(f"wrote {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
