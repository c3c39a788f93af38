"""The torch port's INT8 (Q8) model path against the JAX package.

One quantized numpy tree (int8 values, float32 scales, group size per tensor)
feeds both packages: the JAX side as its ``QuantTensor`` pytree, the port
through ``params_from_numpy``. ``forward`` + ``logits_from_hidden`` (a prefill
segment, then decode steps, then a batched per-row decode) are compared for
the three backend pairs, the kernel pairs on params fused to the
``wqkv``/``w13`` layout (at these narrow widths the JAX package's FFN
megakernel is not eligible, so ``pallas`` runs the composed route; the port's
megakernel has no such limit, so the port gets the ``w13`` layout by fusing
for ``torch``, and ``tests/test_torch_model_mlp_block.py`` holds the
megakernel route at widths where both engage):

* ``torch`` <-> ``xla``: dequantize beside the dot. 1e-4.
* ``cuda-accurate`` <-> ``pallas-accurate``: accurate-mode kernels, RoPE
  outside, the stacked decode kernel. 1e-4, greedy tokens identical.
* ``cuda`` <-> ``pallas``: fast-mode kernels and the glue-fused decode block.
  Both round x to bf16 at the same places, and most steps agree to 1e-6,
  but a last-bit difference in a normed or accumulated x can flip its bf16
  rounding (a step of 2^-8 |x|), and the layers after it carry that: 2e-2
  on hidden states and logits (largest seen 8.5e-3), under the JAX
  tests' own 3e-2 bar for the fast kernel against the float32 oracle.
  Greedy tokens are compared where the JAX top-2 logit margin exceeds
  that bound.

The JAX side runs its Pallas kernels in interpret mode on an unpadded cache
(``init_cache`` without lane padding), which is what lets its glue-fused
branch engage at a narrow head size; a test counts the calls to show that it
did. The tolerance 1e-4 is that of ``tests/test_torch_model.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_params
from llama2_tpu.config import ModelConfig
from llama2_tpu.models import llama as jm
from llama2_tpu.quant import q8 as jq
from llama2_tpu_torch.config import ModelConfig as TorchModelConfig
from llama2_tpu_torch.io.convert import params_from_numpy
from llama2_tpu_torch.models import llama as tm
from llama2_tpu_torch.ops.cuda import attention as tattn
from llama2_tpu_torch.ops.cuda import quant_matmul as tqm
from llama2_tpu_torch.quant import q8 as tq

PAIRS = [("torch", "xla", 1e-4), ("cuda-accurate", "pallas-accurate", 1e-4), ("cuda", "pallas", 2e-2)]


def _cfg(**kw) -> ModelConfig:
    base = dict(dim=64, hidden_dim=172, n_layers=3, n_heads=4, n_kv_heads=2,
                vocab_size=512, seq_len=96)
    base.update(kw)
    return ModelConfig(**base)


CONFIGS = {"gqa": _cfg(), "mha": _cfg(n_kv_heads=4, hidden_dim=160)}


def port_config(c: ModelConfig) -> TorchModelConfig:
    return TorchModelConfig(**{f: getattr(c, f) for f in (
        "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size",
        "seq_len", "norm_eps")})


def quantized_tree(config: ModelConfig, seed: int, group_size: int = 16) -> dict:
    """A numpy param tree with ``(q, scale, group_size)`` triples for the
    matmul weights and an unshared classifier."""
    params = random_params(config, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    params["wcls"] = 0.08 * rng.standard_normal(params["wcls"].shape).astype(np.float32)
    tree = dict(params)
    for k, t in tq.quantize_params(params, group_size).items():
        if isinstance(t, tq.QuantTensor):
            tree[k] = (t.q.numpy(), t.scale.numpy(), t.group_size)
    return tree


def jax_params(tree: dict) -> dict:
    return {
        k: jq.QuantTensor(q=jnp.asarray(v[0]), scale=jnp.asarray(v[1]), group_size=v[2])
        if isinstance(v, tuple) else jnp.asarray(v)
        for k, v in tree.items()
    }


def both_params(tree: dict, backend: str, jax_backend: str):
    jp, tp = jax_params(tree), params_from_numpy(tree, "cpu", torch.float32)
    if backend != "torch":
        jp = jm.fuse_layer_params(jp, jax_backend)
        # the JAX side's layout: w13 here
        tp = tm.fuse_layer_params(tp, "torch" if "w13" in jp else backend)
    return jp, tp


def run_steps(config, jp, tp, backend, jax_backend, steps, batch=1):
    """Drive both forwards over ``steps`` of (tokens, pos); yields the pairs
    of (hidden, logits) as numpy, JAX first."""
    pcfg = port_config(config)
    jcache = jm.init_cache(config, batch)  # unpadded: the glue fusion can engage
    tcache = tm.init_cache(pcfg, batch, torch.float32, "cpu")
    for tok, pos in steps:
        hj, jcache = jm.forward(jp, jcache, jnp.asarray(tok), jnp.asarray(pos), config,
                                backend=jax_backend)
        lj = jm.logits_from_hidden(jp, hj, backend=jax_backend)
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        ht = tm.forward(tp, tcache, torch.from_numpy(tok).long(), tpos, pcfg, backend)
        lt = tm.logits_from_hidden(tp, ht, backend)
        yield (np.asarray(hj), np.asarray(lj)), (ht.numpy(), lt.numpy())
    for key in ("k", "v"):
        yield (np.asarray(jcache[key]), None), (tcache[key].numpy(), None)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("backend,jax_backend,tol", PAIRS, ids=[p[0] for p in PAIRS])
def test_q8_forward_matches_jax(name, backend, jax_backend, tol):
    config = CONFIGS[name]
    tree = quantized_tree(config, seed=len(name))
    jp, tp = both_params(tree, backend, jax_backend)
    if backend != "torch":
        assert tm.layer_keys(tp) == jm.layer_keys(jp) == ("rms_att", "wqkv", "wo", "rms_ffn", "w13", "w2")
    steps = [
        (np.array([[1, 5, 17, 320, 9]], np.int32), 0),
        (np.array([[44]], np.int32), 5),
        (np.array([[3]], np.int32), 6),
    ]
    for (hj, lj), (ht, lt) in run_steps(config, jp, tp, backend, jax_backend, steps):
        np.testing.assert_allclose(ht, hj, rtol=tol, atol=tol)
        if lj is not None:
            assert lt.dtype == np.float32 and lt.shape == lj.shape
            np.testing.assert_allclose(lt, lj, rtol=tol, atol=tol)


@pytest.mark.parametrize("backend,jax_backend,tol", PAIRS, ids=[p[0] for p in PAIRS])
def test_q8_batched_decode_and_greedy_tokens_match_jax(backend, jax_backend, tol):
    """Ten greedy decode steps of a batch of two rows at their own positions,
    as ``tests/test_pallas_kernels.py::test_f32_fused_model_path_token_parity``
    drives the JAX package."""
    config = CONFIGS["gqa"]
    pcfg = port_config(config)
    jp, tp = both_params(quantized_tree(config, seed=3), backend, jax_backend)
    jcache = jm.init_cache(config, 2)
    tcache = tm.init_cache(pcfg, 2, torch.float32, "cpu")
    toks = np.array([[5], [9]], np.int32)
    pos = np.array([0, 3], np.int32)
    compared = 0
    for _ in range(10):
        hj, jcache = jm.forward(jp, jcache, jnp.asarray(toks), jnp.asarray(pos), config,
                                backend=jax_backend)
        lj = np.asarray(jm.logits_from_hidden(jp, hj[:, -1, :], backend=jax_backend))
        ht = tm.forward(tp, tcache, torch.from_numpy(toks).long(), torch.from_numpy(pos), pcfg, backend)
        lt = tm.logits_from_hidden(tp, ht[:, -1, :], backend).numpy()
        np.testing.assert_allclose(lt, lj, rtol=tol, atol=tol)
        top2 = np.sort(lj, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * tol * (1 + np.abs(top2[:, 1]))
        assert (lt.argmax(-1) == lj.argmax(-1))[clear].all()
        compared += int(clear.sum())
        toks = lj.argmax(-1).astype(np.int32)[:, None]  # both follow the JAX stream
        pos = pos + 1
    # the margin guard left most steps in (the fast pair's wider bound: some)
    assert compared >= (15 if tol < 1e-3 else 8)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), rtol=tol, atol=tol)


def test_both_sides_take_the_glue_fused_composed_route(monkeypatch):
    """On ``pallas``/``cuda`` a decode step runs, per layer: the rmsnorm-fused
    wqkv launch, the glue-fused attention, the residual-fused wo launch, then
    w13 and w2 (4 stacked dequant-matmuls and 1 fused attention a layer, no
    stacked decode attention, no FFN megakernel), and 1 classifier matmul."""
    import llama2_tpu.ops.pallas.attention as jattn
    import llama2_tpu.ops.pallas.quant_matmul as jqm

    config = CONFIGS["gqa"]
    pcfg = port_config(config)
    jp, tp = both_params(quantized_tree(config, seed=4), "cuda", "pallas")
    assert not jm.use_mlp_block(jp, "pallas") and not tm.use_mlp_block(tp, "cuda")
    calls = {}

    def counted(module, name, key, record=None):
        orig = getattr(module, name)

        def wrapper(*a, **kw):
            calls[key] = calls.get(key, 0) + 1
            if record is not None:
                calls.setdefault(record, []).append(
                    (kw.get("rms_w") is not None, kw.get("residual") is not None)
                )
            return orig(*a, **kw)

        monkeypatch.setattr(module, name, wrapper)

    counted(jqm, "quant_matmul_stacked", "j_k6", "j_k6_fusions")
    counted(jqm, "quant_matmul", "j_k5")
    counted(jattn, "flash_decode_attention_fused", "j_k4")
    counted(jattn, "flash_decode_attention_stacked", "j_k2")
    counted(tm, "quant_matmul_stacked", "t_k6_direct", "t_k6_fusions")
    counted(tm, "flash_decode_attention_fused", "t_k4")
    counted(tm, "flash_decode_attention_stacked", "t_k2")
    import llama2_tpu_torch.ops.linear as tlin

    counted(tlin, "quant_matmul_stacked", "t_k6_linear")
    counted(tlin, "quant_matmul", "t_k5")

    tok = np.array([[7]], np.int32)
    # the un-jitted forward, so that this call traces; its layer scan traces
    # ONE layer body, so the JAX counts are per layer
    hj, _ = jm.forward.__wrapped__(jp, jm.init_cache(config), jnp.asarray(tok), jnp.asarray(2),
                                   config, backend="pallas", unroll=config.n_layers)
    jm.logits_from_hidden(jp, hj, backend="pallas")
    ht = tm.forward(tp, tm.init_cache(pcfg), torch.from_numpy(tok).long(), 2, pcfg, "cuda")
    tm.logits_from_hidden(tp, ht, "cuda")
    L = config.n_layers
    assert calls["j_k6"] == 4 and calls["j_k4"] == 1 and calls["j_k5"] == 1
    assert "j_k2" not in calls and "t_k2" not in calls
    assert calls["t_k6_direct"] + calls["t_k6_linear"] == 4 * L
    assert calls["t_k4"] == L and calls["t_k5"] == 1
    # per layer, on both sides: one norm-fused (wqkv) and one residual-fused (wo) launch
    assert sorted(calls["j_k6_fusions"]) == sorted([(True, False), (False, True)] + 2 * [(False, False)])
    assert calls["j_k6_fusions"].count((True, False)) == 1
    assert calls["j_k6_fusions"].count((False, True)) == 1
    assert calls["t_k6_fusions"] == [(True, False), (False, True)] * L
    assert calls["t_k6_direct"] == calls["t_k6_linear"] == 2 * L
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=2e-2, atol=2e-2)


def test_accurate_backend_runs_the_stacked_decode_kernel(monkeypatch):
    """``cuda-accurate``: no glue fusion, so a decode layer is K6 (accurate) +
    rope + the stacked decode kernel."""
    config = CONFIGS["gqa"]
    pcfg = port_config(config)
    _, tp = both_params(quantized_tree(config, seed=4), "cuda-accurate", "pallas-accurate")
    seen = []
    orig = tm.flash_decode_attention_stacked
    monkeypatch.setattr(tm, "flash_decode_attention_stacked",
                        lambda *a, **kw: seen.append("k2") or orig(*a, **kw))
    monkeypatch.setattr(tm, "flash_decode_attention_fused",
                        lambda *a, **kw: pytest.fail("the glue-fused kernel ran"))
    modes = []
    orig_k6 = tqm.quant_matmul_stacked
    import llama2_tpu_torch.ops.linear as tlin

    monkeypatch.setattr(tlin, "quant_matmul_stacked",
                        lambda *a, **kw: modes.append(kw["mode"]) or orig_k6(*a, **kw))
    tm.forward(tp, tm.init_cache(pcfg), torch.tensor([[7]]), 2, pcfg, "cuda-accurate")
    assert seen == ["k2"] * config.n_layers
    assert modes == ["accurate"] * (4 * config.n_layers)
    assert tattn.flash_decode_attention_fused.launches == 0  # the CPU never launches


def test_fuse_layer_params_layout():
    config = CONFIGS["gqa"]
    tree = quantized_tree(config, seed=6)
    tp = params_from_numpy(tree, "cpu", torch.float32)
    fused = tm.fuse_layer_params(tp, "cuda-accurate")
    jf = jm.fuse_layer_params(jax_params(tree), "pallas-accurate")
    assert set(fused) == set(jf)
    for k in ("wqkv", "w13"):
        np.testing.assert_array_equal(fused[k].q.numpy(), np.asarray(jf[k].q))
        np.testing.assert_array_equal(fused[k].scale.numpy(), np.asarray(jf[k].scale))
        assert fused[k].group_size == jf[k].group_size
    # the fast backend keeps w1/w3 (the same tensors) for the FFN megakernel
    # and gives the w13 layout to any other backend
    fast = tm.fuse_layer_params(tp)
    assert tm.use_mlp_block(fast, "cuda") and not tm.use_mlp_block(fast, "cuda-accurate")
    assert tm.layer_keys(fast) == ("rms_att", "wqkv", "wo", "rms_ffn", "w1", "w3", "w2")
    assert fast["w1"].q is tp["w1"].q and fast["w3"].scale is tp["w3"].scale
    assert set(tm.fuse_layer_params(tp, "torch")) == set(fused)
    # fp tensors fuse too
    fp = params_from_numpy(random_params(config, seed=1), "cpu", torch.float32)
    ff = tm.fuse_layer_params(fp)
    assert tuple(ff["wqkv"].shape) == (3, 64, 64 + 2 * config.kv_dim)
    assert torch.equal(ff["w13"][..., :172], fp["w1"]) and torch.equal(ff["w13"][..., 172:], fp["w3"])
    assert tm.activation_dtype(fused) == torch.float32
    with pytest.raises(NotImplementedError):
        tm.fuse_layer_params(tp, shards=2)
    mixed = dict(tp, wk=tq.QuantTensor(tp["wk"].q, tp["wk"].scale.repeat_interleave(2, -2), 8))
    with pytest.raises(ValueError, match="group size"):
        tm.fuse_layer_params(mixed)


def test_fused_fp_params_forward_matches_unfused():
    """fp weights in the fused layout run the same math."""
    config = CONFIGS["gqa"]
    pcfg = port_config(config)
    fp = params_from_numpy(random_params(config, seed=2), "cpu", torch.float32)
    tok = torch.tensor([[1, 5, 17, 320, 9]])
    a = tm.forward(fp, tm.init_cache(pcfg), tok, 0, pcfg, "cuda")
    b = tm.forward(tm.fuse_layer_params(fp), tm.init_cache(pcfg), tok, 0, pcfg, "cuda")
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_q8_bf16_activations_close_to_f32():
    """bf16 activations over the same INT8 weights: scales stay float32, the
    hidden states come back in bf16, logits within 3% of their scale of the
    fp32 run (the bar of ``test_bf16_forward_close_to_jax``)."""
    config = CONFIGS["gqa"]
    pcfg = port_config(config)
    tree = quantized_tree(config, seed=7)
    tok = torch.tensor([[1, 5, 17, 320, 9]])
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tp = tm.fuse_layer_params(params_from_numpy(tree, "cpu", dtype))
        assert tp["wqkv"].scale.dtype == torch.float32 and tm.activation_dtype(tp) == dtype
        cache = tm.init_cache(pcfg, 1, dtype)
        h = tm.forward(tp, cache, tok, 0, pcfg, "cuda")
        h1 = tm.forward(tp, cache, torch.tensor([[44]]), 5, pcfg, "cuda")
        assert h.dtype == h1.dtype == dtype
        out[dtype] = tm.logits_from_hidden(tp, h1, "cuda").numpy()
    ref = out[torch.float32]
    assert np.abs(out[torch.bfloat16] - ref).max() < 3e-2 * np.abs(ref).max()
