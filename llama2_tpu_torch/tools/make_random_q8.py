"""Build a random group-quantized INT8 model straight into a param-cache dir.

Port of ``llama2_tpu/tools/make_random_q8.py``: the same numpy generator, so
the same seed gives the same bytes in both packages. Decode throughput at a
given shape does not depend on the weight values, so a random INT8 model of
the exact Llama-2 shape measures the serving path where no real weights are
at hand. Weights are drawn directly as int8 + per-group scales in the
engine's (in, out) QuantTensor layout; no fp32 copy of the model exists
(27 GB at 7B). Scales are sized so that activations stay finite through 32
layers (an effective weight std of ~0.02, Llama's initializer).
``io/convert.py::random_q8_params`` draws a model of the same distribution on
the device, from another generator.

Usage:
    python -m llama2_tpu_torch.tools.make_random_q8 out/llama7b-q8 --model 7b
    python -m llama2_tpu_torch.tools.make_random_q8 out/ --model 1b --seq-len 1024
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from llama2_tpu_torch.config import ModelConfig
from llama2_tpu_torch.io.cache import save_cache
from llama2_tpu_torch.quant.q8 import QuantTensor

# Llama-2 family shapes (meta-llama configs; 7B: dim 4096, 32 layers, MHA,
# hidden 11008 = SwiGLU 2/3 rule rounded to 256)
SHAPES = {
    "7b": dict(dim=4096, hidden_dim=11008, n_layers=32, n_heads=32,
               n_kv_heads=32, vocab_size=32000, seq_len=2048),
    "1b": dict(dim=2048, hidden_dim=5632, n_layers=22, n_heads=32,
               n_kv_heads=4, vocab_size=32000, seq_len=2048),  # TinyLlama-1.1B
    "350m": dict(dim=1024, hidden_dim=2816, n_layers=16, n_heads=16,
                 n_kv_heads=16, vocab_size=32000, seq_len=1024),
    # a shape small enough for a run on the CPU
    "tiny": dict(dim=256, hidden_dim=512, n_layers=2, n_heads=4,
                 n_kv_heads=2, vocab_size=512, seq_len=256),
}


def random_q8_params(config: ModelConfig, group_size: int = 64, seed: int = 0) -> dict:
    """Random INT8 param tree in the engine layout: QuantTensors of CPU
    tensors and fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    L, D, HD, V = config.n_layers, config.dim, config.hidden_dim, config.vocab_size
    KV = config.kv_dim

    def qt(*shape):
        """QuantTensor of shape (..., in, out): random int8, jittered scales
        targeting an effective weight std of ~0.02."""
        n_in = shape[-2]
        q = rng.integers(-127, 128, size=shape, dtype=np.int64).astype(np.int8)
        sshape = (*shape[:-2], n_in // group_size, shape[-1])
        # int8 uniform has std ~73; 0.02/73 ≈ 2.7e-4 nominal scale
        scale = (2.7e-4 * rng.uniform(0.7, 1.3, size=sshape)).astype(np.float32)
        return QuantTensor(torch.from_numpy(q), torch.from_numpy(scale), group_size)

    def f32(*shape, loc=0.0, sd=0.02):
        return (loc + sd * rng.standard_normal(shape)).astype(np.float32)

    return {
        "tok_emb": f32(V, D),
        "rms_att": f32(L, D, loc=1.0),
        "wq": qt(L, D, D),
        "wk": qt(L, D, KV),
        "wv": qt(L, D, KV),
        "wo": qt(L, D, D),
        "rms_ffn": f32(L, D, loc=1.0),
        "w1": qt(L, D, HD),
        "w2": qt(L, HD, D),
        "w3": qt(L, D, HD),
        "rms_final": f32(D, loc=1.0),
        "wcls": qt(D, V),
    }


def build(out_dir: str, model: str = "7b", group_size: int = 64,
          seed: int = 0, seq_len: int | None = None) -> ModelConfig:
    shape = dict(SHAPES[model])
    if seq_len is not None:
        shape["seq_len"] = seq_len
    config = ModelConfig(**shape)
    save_cache(out_dir, config, random_q8_params(config, group_size, seed), shared=False)
    return config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--model", choices=sorted(SHAPES), default="7b")
    ap.add_argument("--group-size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seq-len", type=int, default=None)
    args = ap.parse_args(argv)
    config = build(args.out_dir, args.model, args.group_size, args.seed, args.seq_len)
    print(f"wrote {args.model} ({config}) cache to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
