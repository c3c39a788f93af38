"""The torch port's whole-layer decode kernel (K13) against the JAX package.

``llama2_tpu_torch/ops/cuda/layer_block.py::layer_block_stacked`` on CPU
tensors runs its plain version. It is held against the JAX
``layer_block_stacked`` (its Pallas kernel in interpret mode) at the cases
and config of ``tests/test_layer_block.py::test_layer_block_vs_two_launch``,
and against the port's own composition of the glue-fused int8 attention (K9)
and the wo/FFN/next-QKV megakernel (K12, or K11 for the last layer), as the
JAX test holds its kernel against the JAX pair.

Tolerances:
* against JAX: the same function, computed with float32 sums in another
  order, whose operands are rounded to bf16 at every matmul (the virtual
  row's score, ``att``, the normed rows, the swiglu product): a sum on a
  rounding boundary flips one bf16 operand now and then, so the bound is
  ``TOL_JAX`` of the output's largest magnitude (``pytest -s`` prints the
  largest seen). Cache appends: equal bytes; scales to one float32 ulp (the
  compiled JAX kernel multiplies ``amax`` by the reciprocal of 127).
* against K9 + K12: ``2e-2 x max|want|`` as the JAX test has it (the virtual
  row's value is float32 in K13 and bf16-rounded in K9, and ``att`` is not
  rounded to the activation dtype), the appends bit-equal.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama2_tpu.config import ModelConfig
from llama2_tpu.models import llama as jm
from llama2_tpu.ops import xla as jops
from llama2_tpu.ops.pallas.layer_block import layer_block_stacked as jax_layer_block
from llama2_tpu.quant import q8 as jq
from llama2_tpu_torch.io.convert import params_from_numpy
from llama2_tpu_torch.models import llama as tm
from llama2_tpu_torch.ops.cuda import attention_q8 as aq
from llama2_tpu_torch.ops.cuda import layer_block as lb
from llama2_tpu_torch.ops.cuda import mlp_block as mb
from llama2_tpu_torch.quant import q8 as tq

EPS = 1e-5
TOL_JAX = 2e-3
WORST = {}


def _cfg(L=3, D=256, HD=384, H=2, KVH=2, V=128, S=128):
    return ModelConfig(dim=D, hidden_dim=HD, n_layers=L, n_heads=H, n_kv_heads=KVH,
                       vocab_size=V, seq_len=S, norm_eps=EPS)


def _fp_params(cfg, seed):
    """``tests/test_layer_block.py::_params``' recipe, before quantization."""
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.standard_normal(s, np.float32) * 0.05

    L, D, HD, V, KV = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size, cfg.kv_dim
    return {
        "tok_emb": r(V, D), "rms_att": 1 + r(L, D), "wq": r(L, D, D),
        "wk": r(L, D, KV), "wv": r(L, D, KV), "wo": r(L, D, D),
        "rms_ffn": 1 + r(L, D), "w1": r(L, D, HD), "w2": r(L, HD, D),
        "w3": r(L, D, HD), "rms_final": 1 + r(D), "wcls": r(D, V),
    }


def both_trees(cfg, seed):
    """The same INT8 params fused for each package's fast kernel backend."""
    params = _fp_params(cfg, seed)
    tree = dict(params)
    for k, t in tq.quantize_params(params, 64).items():
        if isinstance(t, tq.QuantTensor):
            tree[k] = (t.q.numpy(), t.scale.numpy(), t.group_size)
    jp = {
        k: jq.QuantTensor(q=jnp.asarray(v[0]), scale=jnp.asarray(v[1]), group_size=v[2])
        if isinstance(v, tuple) else jnp.asarray(v)
        for k, v in tree.items()
    }
    return jm.fuse_layer_params(jp, "pallas"), tm.fuse_layer_params(params_from_numpy(tree, "cpu", torch.float32), "cuda")


def _inputs(cfg, B, pos0):
    """``test_layer_block_vs_two_launch``'s draws: qkv3, x, positions, rope
    tables, and the cache bytes both sides start from."""
    rng = np.random.default_rng(7)
    H, KVH, hs = cfg.n_heads, cfg.n_kv_heads, cfg.head_size
    qkv3 = rng.standard_normal((B, H + 2 * KVH, hs), np.float32)
    x = rng.standard_normal((B, cfg.dim), np.float32) * 0.1
    pos = np.asarray([pos0 + 3 * b for b in range(B)], np.int32)
    cos, sin = jops.rope_angles(jnp.asarray(pos)[:, None], hs)
    cos_il = np.asarray(jnp.repeat(cos.reshape(B, -1), 2, axis=-1))
    sin_il = np.asarray(jnp.repeat(sin.reshape(B, -1), 2, axis=-1))
    shape = (cfg.n_layers, B, KVH, cfg.seq_len, hs)
    k8 = rng.integers(-100, 100, shape).astype(np.int8)
    sc = rng.uniform(0.001, 0.01, shape[:-1]).astype(np.float32)
    caches = (k8, sc, np.roll(k8, 1, axis=-1), sc * np.float32(1.1))
    return qkv3, x, pos, cos_il, sin_il, caches


def _port_call(fn, tp, cfg, qkv3, x, pos, cos_il, sin_il, caches, layer, with_qkv):
    tc = [torch.from_numpy(a.copy()) for a in caches]
    w = [tp[k] for k in ("wo", "rms_ffn", "w1", "w3", "w2", "rms_att", "wqkv")]
    out, qn = fn(torch.from_numpy(qkv3), torch.from_numpy(x), *tc, torch.from_numpy(cos_il),
                 torch.from_numpy(sin_il), *w, layer, torch.from_numpy(pos),
                 n_heads=cfg.n_heads, eps=EPS, with_qkv=with_qkv)
    return out, qn, tc


CASES = [(2, 5, True), (2, 5, False), (1, 0, True), (4, 100, True)]


@pytest.mark.parametrize("B,pos0,with_qkv", CASES)
def test_layer_block_plain_matches_jax(B, pos0, with_qkv):
    cfg = _cfg()
    jp, tp = both_trees(cfg, seed=B + pos0)
    assert lb.layer_block_supported(*(tp[k] for k in ("wo", "w1", "w3", "w2", "wqkv")), cfg)
    qkv3, x, pos, cos_il, sin_il, caches = _inputs(cfg, B, pos0)
    layer = 1
    want, qn_want, *jc = jax_layer_block(
        jnp.asarray(qkv3), jnp.asarray(x), *(jnp.asarray(a) for a in caches), jnp.asarray(cos_il),
        jnp.asarray(sin_il), jp["wo"], jp["rms_ffn"], jp["w1"], jp["w3"], jp["w2"], jp["rms_att"],
        jp["wqkv"], jnp.int32(layer), jnp.asarray(pos), n_heads=cfg.n_heads, eps=EPS,
        with_qkv=with_qkv, interpret=True,
    )
    got, qn_got, tc = _port_call(lb.layer_block_stacked, tp, cfg, qkv3, x, pos, cos_il, sin_il,
                                 caches, layer, with_qkv)
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc[0]))
    np.testing.assert_array_equal(tc[2].numpy(), np.asarray(jc[2]))
    for i in (1, 3):
        np.testing.assert_allclose(tc[i].numpy(), np.asarray(jc[i]), rtol=1.2e-7, atol=0)
    pairs = [("out", got, want)] + ([("qkv'", qn_got, qn_want)] if with_qkv else [])
    assert (qn_got is None) == (not with_qkv)
    for name, g, w in pairs:
        g, w = g.numpy(), np.asarray(w)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=TOL_JAX * scale, rtol=0)
        WORST[name] = max(WORST.get(name, 0.0), float(np.abs(g - w).max()) / scale)
        print(f"largest |port - JAX| / max|JAX|, K13 {name}: {WORST[name]:.2e}")  # pytest -s


def _k9_then_k12(tp, cfg, qkv3, x, pos, cos_il, sin_il, caches, layer, with_qkv):
    """The port's two-launch composition on the same inputs."""
    tc = [torch.from_numpy(a.copy()) for a in caches]
    att = aq.flash_decode_attention_q8_fused(
        torch.from_numpy(qkv3), *tc, torch.from_numpy(cos_il), torch.from_numpy(sin_il), layer,
        torch.from_numpy(pos), n_heads=cfg.n_heads,
    ).reshape(x.shape)
    xt = torch.from_numpy(x)
    if with_qkv:
        out, qn = mb.layer_tail_qkv_stacked(att, xt, tp["wo"], tp["rms_ffn"], tp["w1"], tp["w3"],
                                            tp["w2"], tp["rms_att"], tp["wqkv"], layer, EPS)
    else:
        out, qn = mb.attn_mlp_block_stacked(att, xt, tp["wo"], tp["rms_ffn"][layer], tp["w1"],
                                            tp["w3"], tp["w2"], layer, EPS), None
    return out, qn, tc


@pytest.mark.parametrize("B,pos0,with_qkv", CASES)
def test_layer_block_plain_vs_k9_then_k12(B, pos0, with_qkv):
    cfg = _cfg()
    _, tp = both_trees(cfg, seed=B + pos0)
    args = _inputs(cfg, B, pos0)
    got, qn_got, c_got = _port_call(lb.layer_block_stacked, tp, cfg, *args, 1, with_qkv)
    want, qn_want, c_want = _k9_then_k12(tp, cfg, *args, 1, with_qkv)
    for a, b in zip(c_got, c_want):
        assert torch.equal(a, b)
    for g, w in [(got, want)] + ([(qn_got, qn_want)] if with_qkv else []):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, atol=2e-2 * scale, rtol=2e-2)


def test_layer_block_virtual_row_alone_at_pos_0():
    """An empty cache: only this step's row is attended, with its float32
    dequantized value: att equals that value for every query head."""
    cfg = _cfg(L=1)
    _, tp = both_trees(cfg, seed=3)
    qkv3, x, pos, cos_il, sin_il, caches = _inputs(cfg, 1, 0)
    q, (k8, ks, v8, vs) = aq.rope_quantize_plain(torch.from_numpy(qkv3), torch.from_numpy(cos_il),
                                                 torch.from_numpy(sin_il), cfg.n_heads)
    att = lb._virtual_attend_plain(q, *(torch.from_numpy(a[0]) for a in caches), (k8, ks, v8, vs),
                                   torch.from_numpy(pos), 1.0 / cfg.head_size**0.5)
    vd = aq.dequantize_kv(v8, vs)  # (1, KVH, hs) with KVH == H here
    assert torch.equal(att, vd.reshape(1, -1))


def test_layer_block_supported_states_the_ports_limits():
    cfg = _cfg()
    _, tp = both_trees(cfg, seed=0)
    w = [tp[k] for k in ("wo", "w1", "w3", "w2", "wqkv")]
    assert lb.layer_block_supported(*w, cfg)
    # no 128-alignment rules: head size 64 and an odd cache length are fine
    cfg64 = _cfg(H=4, KVH=4)
    _, tp64 = both_trees(cfg64, seed=0)
    assert lb.layer_block_supported(*(tp64[k] for k in ("wo", "w1", "w3", "w2", "wqkv")), cfg64)
    # query heads that do not divide over the kv heads
    bad_heads = types.SimpleNamespace(n_heads=4, n_kv_heads=3, head_size=64)
    assert not lb.layer_block_supported(*w, bad_heads)
    # a quant group wider than a head (hs = 32 < group 64)
    cfg_small = _cfg(D=128, HD=256, H=4, KVH=4)
    _, tps = both_trees(cfg_small, seed=0)
    assert not lb.layer_block_supported(*(tps[k] for k in ("wo", "w1", "w3", "w2", "wqkv")), cfg_small)
    # an fp wo: the megakernels take quantized stacks only
    assert not lb.layer_block_supported(tq.dequantize(tp["wo"], torch.float32), *w[1:], cfg)
