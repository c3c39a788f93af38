"""The torch port's int8 KV cache attention (K7, K8, K9) against the JAX package.

Seeded numpy inputs go through the JAX functions of
``llama2_tpu/ops/pallas/attention_q8.py`` (the Pallas kernels in interpret
mode on the CPU, as ``tests/test_kv_quant.py`` runs them) and through the
port's wrappers on CPU tensors, which run the plain versions.

* ``quantize_kv_rows``: the same int8 bytes and float32 scales as the JAX
  function, for float32 and for bf16 rows (bf16 arithmetic in both), a zero
  row included.
* K7, K8, K9 outputs: float32 to ``ATOL`` + ``RTOL``; the two sides take the
  same roundings (bf16 query, bf16 ``p * v_scale``) and differ only in the
  order of float32 sums. The largest difference seen is printed by
  ``pytest -s``. Cache appends: equal bytes; K9's appended scales to one
  float32 ulp (the compiled JAX kernel multiplies ``amax`` by the reciprocal
  of 127, the port divides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama2_tpu.ops import xla as jops
from llama2_tpu.ops.pallas import attention_q8 as jq8
from llama2_tpu_torch.ops import ref
from llama2_tpu_torch.ops.cuda import attention_q8 as tq8

ATOL = 1e-5
RTOL = 1e-5
WORST = {}


def _close(name, got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    WORST[name] = max(WORST.get(name, 0.0), float(np.abs(got - want).max()))
    print(f"largest |port - JAX| so far, {name}: {WORST[name]:.3e}")  # shown by pytest -s


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, as float32 (the same values on both sides)."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_same_bytes_as_jax(dtype):
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((3, 4, 17, 32)).astype(np.float32)
    rows *= rng.uniform(1e-3, 30.0, (3, 4, 17, 1)).astype(np.float32)
    rows[0, 0, 0] = 0.0  # a zero row: scale 0, bytes 0, no NaN
    if dtype == "bfloat16":
        rows = _bf16_values(rows)
    jq, js = jq8.quantize_kv_rows(jnp.asarray(rows).astype(getattr(jnp, dtype)))
    tq, ts = tq8.quantize_kv_rows(torch.from_numpy(rows).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (3, 4, 17)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 0, 0] == 0 and not torch.isnan(tq8.dequantize_kv(tq, ts)).any()
    np.testing.assert_array_equal(
        tq8.dequantize_kv(tq, ts).numpy(), np.asarray(jq8.dequantize_kv(jq, js))
    )


def _quantized_cache(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    q, s = jq8.quantize_kv_rows(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def _k7_both(q, k8, ks, v8, vs, pos):
    got = tq8.flash_decode_attention_q8(
        torch.from_numpy(q), *(torch.from_numpy(a) for a in (k8, ks, v8, vs)), pos
    )
    want = jq8.flash_decode_attention_q8(
        jnp.asarray(q), *(jnp.asarray(a) for a in (k8, ks, v8, vs)), pos, interpret=True
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("pos", [0, 7, 31])
@pytest.mark.parametrize("gqa", [False, True])
def test_k7_decode_matches_jax(pos, gqa):
    """The shapes of ``test_kv_quant.py::test_q8_flash_decode_vs_dequant_oracle``."""
    B, S, hs, KVH = 2, 32, 16, 2
    H = 4 if gqa else KVH
    rng = np.random.default_rng(pos + 10 * gqa)
    q = rng.standard_normal((B, 1, H, hs)).astype(np.float32)
    k8, ks = _quantized_cache(rng, (B, KVH, S, hs))
    v8, vs = _quantized_cache(rng, (B, KVH, S, hs))
    got, want = _k7_both(q, k8, ks, v8, vs, pos)
    assert got.shape == (B, 1, H, hs)
    _close("K7", got, want)
    # (B, H, hs) queries take the same path
    got3, want3 = _k7_both(q[:, 0], k8, ks, v8, vs, pos)
    _close("K7", got3, want3)


@pytest.mark.parametrize("T", [2, 4])
def test_k7_window_matches_jax(T):
    """A verify window (``test_q8_flash_window_vs_oracle``): row t sees keys up
    to last - (T - 1) + t."""
    B, S, hs, KVH, H = 1, 32, 16, 2, 4
    rng = np.random.default_rng(T)
    q = rng.standard_normal((B, T, H, hs)).astype(np.float32)
    k8, ks = _quantized_cache(rng, (B, KVH, S, hs))
    v8, vs = _quantized_cache(rng, (B, KVH, S, hs))
    got, want = _k7_both(q, k8, ks, v8, vs, 19)
    _close("K7", got, want)
    # each row equals a T = 1 call at its own position
    for t in range(T):
        one, _ = _k7_both(q[:, t : t + 1], k8, ks, v8, vs, 19 - (T - 1) + t)
        np.testing.assert_array_equal(one, got[:, t : t + 1])


@pytest.mark.parametrize("S", [96, 160, 200])
def test_k7_awkward_cache_lengths(S):
    """``test_q8_block_picker_awkward_seq_lens``: seq_len plus a speculative pad."""
    B, KVH, H, hs = 1, 2, 2, 16
    rng = np.random.default_rng(S)
    q = rng.standard_normal((B, 1, H, hs)).astype(np.float32)
    k8, ks = _quantized_cache(rng, (B, KVH, S, hs))
    v8, vs = _quantized_cache(rng, (B, KVH, S, hs))
    got, want = _k7_both(q, k8, ks, v8, vs, S - 1)
    _close("K7", got, want)


def test_k7_bf16_queries_round_like_jax():
    """bf16 queries: the int8 route is a bf16-dot route either way; the output
    comes back in bf16."""
    B, S, hs, KVH, H = 2, 64, 32, 2, 4
    rng = np.random.default_rng(3)
    q = _bf16_values(rng.standard_normal((B, 3, H, hs)).astype(np.float32))
    k8, ks = _quantized_cache(rng, (B, KVH, S, hs))
    v8, vs = _quantized_cache(rng, (B, KVH, S, hs))
    got = tq8.flash_decode_attention_q8(
        torch.from_numpy(q).bfloat16(), *(torch.from_numpy(a) for a in (k8, ks, v8, vs)), 40
    )
    want = jq8.flash_decode_attention_q8(
        jnp.asarray(q).astype(jnp.bfloat16), *(jnp.asarray(a) for a in (k8, ks, v8, vs)), 40,
        interpret=True,
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=1e-3, rtol=2**-7)


def test_k7_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 17, 2, 16)
    k8 = torch.zeros(1, 2, 32, 16, dtype=torch.int8)
    ks = torch.zeros(1, 2, 32)
    with pytest.raises(ValueError):  # a window past 16 rows
        tq8.flash_decode_attention_q8(q, k8, ks, k8, ks, 20)
    with pytest.raises(ValueError):  # an odd head size
        tq8.flash_decode_attention_q8(torch.zeros(1, 1, 2, 15), k8[..., :15], ks, k8[..., :15], ks, 3)
    with pytest.raises(ValueError):  # scales that are not float32
        tq8.flash_decode_attention_q8(q[:, :1], k8, ks.double(), k8, ks, 3)


# test_kv_quant.py::test_q8_fused_attention_block_vs_stacked's shapes
L, B, KVH, S, HS, H = 3, 2, 2, 256, 128, 4
POS = [37, 130]
LAYER = 1


def _stacked_inputs():
    rng = np.random.default_rng(1)
    k8, ks = _quantized_cache(rng, (L, B, KVH, S, HS))
    v8, vs = _quantized_cache(rng, (L, B, KVH, S, HS))
    qkv = rng.standard_normal((B, H + 2 * KVH, HS)).astype(np.float32)
    return (k8, ks, v8, vs), qkv


def _rope_tables(pos):
    cos, sin = jops.rope_angles(jnp.asarray(pos, jnp.int32)[:, None], HS)  # (B, 1, hs/2)
    return np.asarray(jnp.repeat(cos[:, 0], 2, -1)), np.asarray(jnp.repeat(sin[:, 0], 2, -1))


def test_k8_matches_jax():
    caches, qkv = _stacked_inputs()
    pos = np.asarray(POS, np.int32)
    cos, sin = jops.rope_angles(jnp.asarray(pos)[:, None], HS)
    q = np.asarray(jops.apply_rope(jnp.asarray(qkv[:, :H])[:, None], cos, sin)[:, 0])
    kn = jops.apply_rope(jnp.asarray(qkv[:, H : H + KVH])[:, None], cos, sin)[:, 0]
    news = [np.asarray(a) for a in (*jq8.quantize_kv_rows(kn[:, :, None, :]),
                                    *jq8.quantize_kv_rows(jnp.asarray(qkv[:, H + KVH :])[:, :, None, :]))]
    want, *jc = jq8.flash_decode_attention_q8_stacked(
        jnp.asarray(q), *(jnp.asarray(a) for a in caches), *(jnp.asarray(a) for a in news),
        LAYER, jnp.asarray(pos), interpret=True,
    )
    tc = [torch.from_numpy(a.copy()) for a in caches]
    got = tq8.flash_decode_attention_q8_stacked(
        torch.from_numpy(q), *tc, *(torch.from_numpy(a) for a in news), LAYER, torch.from_numpy(pos)
    )
    assert got.shape == (B, H, HS)
    _close("K8", got.numpy(), want)
    for t, j in zip(tc, jc):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_k9_matches_jax():
    caches, qkv = _stacked_inputs()
    pos = np.asarray(POS, np.int32)
    cos_il, sin_il = _rope_tables(pos)
    want, *jc = jq8.flash_decode_attention_q8_fused(
        jnp.asarray(qkv), *(jnp.asarray(a) for a in caches), jnp.asarray(cos_il), jnp.asarray(sin_il),
        LAYER, jnp.asarray(pos), n_heads=H, interpret=True,
    )
    tc = [torch.from_numpy(a.copy()) for a in caches]
    got = tq8.flash_decode_attention_q8_fused(
        torch.from_numpy(qkv), *tc, torch.from_numpy(cos_il), torch.from_numpy(sin_il), LAYER,
        torch.from_numpy(pos), n_heads=H,
    )
    _close("K9", got.numpy(), want)
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc[0]))  # K bytes
    np.testing.assert_array_equal(tc[2].numpy(), np.asarray(jc[2]))  # V bytes
    for i in (1, 3):  # scales: one ulp at most, only at the appended rows
        np.testing.assert_allclose(tc[i].numpy(), np.asarray(jc[i]), rtol=1.2e-7, atol=0)
        assert not (tc[i].numpy() != caches[i])[[0, 2]].any()  # other layers untouched


def test_k9_equals_rope_quantize_then_k8():
    """The glue-fused form is the stacked one on rows rotated and quantized in
    float32 (the port's plain versions, bit for bit)."""
    caches, qkv = _stacked_inputs()
    pos = torch.tensor(POS, dtype=torch.int32)
    cos_il, sin_il = (torch.from_numpy(a) for a in _rope_tables(POS))
    c9 = [torch.from_numpy(a.copy()) for a in caches]
    c8 = [torch.from_numpy(a.copy()) for a in caches]
    att9 = tq8.flash_decode_attention_q8_fused(torch.from_numpy(qkv), *c9, cos_il, sin_il, LAYER, pos, n_heads=H)
    q, (k8, ks, v8, vs) = tq8.rope_quantize_plain(torch.from_numpy(qkv), cos_il, sin_il, H)
    att8 = tq8.flash_decode_attention_q8_stacked(q, *c8, k8[:, :, None], ks[..., None], v8[:, :, None],
                                                 vs[..., None], LAYER, pos)
    assert torch.equal(att9, att8)
    assert all(torch.equal(a, b) for a, b in zip(c9, c8))
    # the rotation is the plain rope's on the same tables, bit for bit
    cos, sin = cos_il[:, None, 0::2], sin_il[:, None, 0::2]
    assert torch.equal(q, ref.apply_rope(torch.from_numpy(qkv)[:, None, :H], cos, sin)[:, 0])
