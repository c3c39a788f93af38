"""The torch port's attention kernels K1/K2/K4 against the JAX Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions, which are held
against ``flash_prefill_attention``, ``flash_decode_attention_stacked`` and
``flash_decode_attention_fused`` of ``llama2_tpu/ops/pallas`` in interpret
mode, on the shape lists of ``tests/test_pallas_kernels.py`` with its
tolerance (rtol/atol 2e-5). K2 also checks the in-place append: only rows
``[layer, b, :, pos_b]`` change. K4 (RoPE on the raw QKV rows + append +
attention): attention output to 1e-5 for an fp32 cache, the appended rows to
1e-6 (XLA may fuse the rope mul-adds inside the JAX kernel graph). The
CUDA kernels themselves are checked against the plain versions on the card
by ``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama2_tpu.ops import xla as jops
from llama2_tpu.ops.pallas.attention import flash_decode_attention_fused as jax_k4
from llama2_tpu.ops.pallas.attention import flash_decode_attention_stacked as jax_k2
from llama2_tpu.ops.pallas.prefill_attention import flash_prefill_attention as jax_k1
from llama2_tpu_torch.ops.cuda.attention import (
    flash_decode_attention_fused,
    flash_decode_attention_stacked,
)
from llama2_tpu_torch.ops.cuda.prefill_attention import flash_prefill_attention

TOL = dict(rtol=2e-5, atol=2e-5)

# tests/test_pallas_kernels.py::test_flash_prefill_vs_oracle
PREFILL_SHAPES = [
    (1, 8, 6, 6, 48, 64, 0),
    (1, 8, 6, 6, 48, 64, 13),  # continuation segment
    (2, 16, 8, 2, 64, 128, 32),  # GQA batch
    (1, 5, 4, 1, 32, 64, 10),  # MQA, T not a power of two
    (1, 7, 4, 2, 64, 64, 0),  # odd T
]


@pytest.mark.parametrize("B,T,H,KVH,hs,S,pos", PREFILL_SHAPES)
def test_prefill_plain_vs_jax_kernel(B, T, H, KVH, hs, S, pos):
    rng = np.random.default_rng(T * 10 + pos)
    q = rng.standard_normal((B, T, H, hs)).astype(np.float32)
    k = rng.standard_normal((B, KVH, S, hs)).astype(np.float32)
    v = rng.standard_normal((B, KVH, S, hs)).astype(np.float32)
    want = np.asarray(
        jax_k1(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, interpret=True)
    )
    before = flash_prefill_attention.launches
    got = flash_prefill_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos)
    assert flash_prefill_attention.launches == before  # CPU tensors: plain, no launch
    assert got.shape == (B, T, H, hs) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# tests/test_pallas_kernels.py::test_flash_decode_vs_oracle (as single-row
# positions over a 2-layer stack), its per-row case, and
# ::test_flash_decode_stacked_matches_oracle
DECODE_SHAPES = [
    (2, 1, 6, 6, 48, 256, [0]),  # stories15M shapes, first token
    (2, 1, 6, 6, 48, 256, [100]),
    (2, 1, 6, 6, 48, 256, [255]),  # full cache
    (2, 2, 8, 2, 64, 128, [127, 127]),  # GQA, batch
    (2, 1, 4, 1, 32, 64, [17]),  # MQA
    (2, 1, 32, 4, 128, 512, [300]),  # llama-7B-ish head layout
    (2, 3, 4, 2, 64, 128, [5, 77, 127]),  # per-row positions
    (3, 2, 4, 2, 128, 32, [5, 9]),  # the stacked-kernel test's case
]


@pytest.mark.parametrize("L,B,H,KVH,hs,S,pos", DECODE_SHAPES)
def test_decode_stacked_plain_vs_jax_kernel(L, B, H, KVH, hs, S, pos):
    rng = np.random.default_rng(B * 100 + pos[0])
    k_cache = rng.standard_normal((L, B, KVH, S, hs)).astype(np.float32)
    v_cache = rng.standard_normal((L, B, KVH, S, hs)).astype(np.float32)
    q = rng.standard_normal((B, 1, H, hs)).astype(np.float32)
    k_new = rng.standard_normal((B, KVH, 1, hs)).astype(np.float32)
    v_new = rng.standard_normal((B, KVH, 1, hs)).astype(np.float32)
    layer = L - 1
    pos_np = np.asarray(pos, np.int32)

    out_j, k_j, v_j = jax_k2(
        jnp.asarray(q), jnp.asarray(k_cache), jnp.asarray(v_cache),
        jnp.asarray(k_new), jnp.asarray(v_new), layer, jnp.asarray(pos_np),
        interpret=True,
    )
    kc, vc = torch.from_numpy(k_cache.copy()), torch.from_numpy(v_cache.copy())
    before = flash_decode_attention_stacked.launches
    out = flash_decode_attention_stacked(
        torch.from_numpy(q), kc, vc, torch.from_numpy(k_new), torch.from_numpy(v_new),
        layer, torch.from_numpy(pos_np),
    )
    assert flash_decode_attention_stacked.launches == before
    assert out.shape == (B, 1, H, hs)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)

    # in place, and only the rows [layer, b, :, pos_b], to the new rows
    want_k, want_v = k_cache.copy(), v_cache.copy()
    for b, p in enumerate(pos):
        want_k[layer, b, :, p] = k_new[b, :, 0]
        want_v[layer, b, :, p] = v_new[b, :, 0]
    np.testing.assert_array_equal(kc.numpy(), want_k)
    np.testing.assert_array_equal(vc.numpy(), want_v)
    np.testing.assert_array_equal(np.asarray(k_j), want_k)
    np.testing.assert_array_equal(np.asarray(v_j), want_v)


def test_decode_accepts_q_without_token_axis():
    rng = np.random.default_rng(0)
    kc = torch.from_numpy(rng.standard_normal((2, 1, 2, 16, 8)).astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal((2, 1, 2, 16, 8)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((1, 4, 8)).astype(np.float32))
    new = torch.zeros(1, 2, 1, 8)
    pos = torch.tensor([3], dtype=torch.int32)
    out3 = flash_decode_attention_stacked(q, kc.clone(), vc.clone(), new, new, 0, pos)
    out4 = flash_decode_attention_stacked(q[:, None], kc.clone(), vc.clone(), new, new, 0, pos)
    assert out3.shape == (1, 4, 8) and out4.shape == (1, 1, 4, 8)
    assert torch.equal(out3, out4[:, 0])


@pytest.mark.parametrize(
    "bad",
    ["q_rank", "cache_shape", "kv_mismatch", "segment_past_cache", "meta_device"],
)
def test_prefill_wrapper_rejects(bad):
    q, k, v, pos = torch.zeros(1, 4, 4, 8), torch.zeros(1, 2, 16, 8), torch.zeros(1, 2, 16, 8), 0
    if bad == "q_rank":
        q = q[0]
    elif bad == "cache_shape":
        k = v = torch.zeros(1, 2, 16, 4)
    elif bad == "kv_mismatch":
        v = torch.zeros(1, 2, 8, 8)
    elif bad == "segment_past_cache":
        pos = 13
    else:  # no silent fallback for a device the wrapper does not serve
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises(ValueError):
        flash_prefill_attention(q, k, v, pos)


@pytest.mark.parametrize("bad", ["pos_dtype", "pos_shape", "new_shape", "layer", "meta_device"])
def test_decode_wrapper_rejects(bad):
    q = torch.zeros(2, 4, 8)
    kc, vc = torch.zeros(2, 2, 2, 16, 8), torch.zeros(2, 2, 2, 16, 8)
    kn, vn = torch.zeros(2, 2, 1, 8), torch.zeros(2, 2, 1, 8)
    layer, pos = 0, torch.tensor([1, 2], dtype=torch.int32)
    if bad == "pos_dtype":
        pos = pos.long()
    elif bad == "pos_shape":
        pos = pos[:1]
    elif bad == "new_shape":
        kn = torch.zeros(2, 2, 8)
    elif bad == "layer":
        layer = 2
    else:
        q, kc, vc, kn, vn, pos = (t.to("meta") for t in (q, kc, vc, kn, vn, pos))
    with pytest.raises(ValueError):
        flash_decode_attention_stacked(q, kc, vc, kn, vn, layer, pos)


# ---- K4: the glue-fused decode attention ----

# (L, B, H, KVH, hs, S, pos)
FUSED_SHAPES = [
    (3, 2, 4, 2, 128, 256, [37, 130]),  # tests/test_pallas_kernels.py's fused case: GQA, per-row
    (2, 1, 6, 6, 48, 256, [0]),  # MHA, stories15M head size, first token
    (2, 1, 6, 6, 48, 256, [255]),  # full cache
    (2, 3, 8, 2, 64, 128, [5, 77, 127]),  # GQA, per-row positions
    (2, 1, 4, 1, 32, 64, [17]),  # MQA
]


def rope_tables(pos_np: np.ndarray, hs: int):
    """The step's pair-duplicated (B, hs) float32 cos/sin rows."""
    cos, sin = jops.rope_angles(jnp.asarray(pos_np)[:, None], hs)
    return np.array(jnp.repeat(cos[:, 0], 2, -1)), np.array(jnp.repeat(sin[:, 0], 2, -1))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,B,H,KVH,hs,S,pos", FUSED_SHAPES)
def test_decode_fused_plain_vs_jax_kernel(L, B, H, KVH, hs, S, pos, cache_dtype):
    rng = np.random.default_rng(B * 100 + pos[0] + hs)
    jdt, tdt = (jnp.float32, torch.float32) if cache_dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    k_cache = rng.standard_normal((L, B, KVH, S, hs)).astype(np.float32)
    v_cache = rng.standard_normal((L, B, KVH, S, hs)).astype(np.float32)
    qkv = rng.standard_normal((B, H + 2 * KVH, hs)).astype(np.float32)
    layer = L - 1
    pos_np = np.asarray(pos, np.int32)
    cos_il, sin_il = rope_tables(pos_np, hs)

    att_j, k_j, v_j = jax_k4(
        jnp.asarray(qkv, jdt), jnp.asarray(k_cache, jdt), jnp.asarray(v_cache, jdt),
        jnp.asarray(cos_il), jnp.asarray(sin_il), layer, jnp.asarray(pos_np),
        n_heads=H, interpret=True,
    )
    kc = torch.from_numpy(k_cache.copy()).to(tdt)
    vc = torch.from_numpy(v_cache.copy()).to(tdt)
    k_before, v_before = kc.clone(), vc.clone()
    before = flash_decode_attention_fused.launches
    att = flash_decode_attention_fused(
        torch.from_numpy(qkv).to(tdt), kc, vc, torch.from_numpy(cos_il),
        torch.from_numpy(sin_il), layer, torch.from_numpy(pos_np), n_heads=H,
    )
    assert flash_decode_attention_fused.launches == before  # CPU tensors: plain, no launch
    assert att.shape == (B, H, hs) and att.dtype == tdt
    # fp32: summation order only. bf16: both compute in f32 on the same
    # bf16 inputs and round the output once, so one last-bit flip at most
    tol = dict(rtol=1e-5, atol=1e-5) if tdt == torch.float32 else dict(rtol=2**-7, atol=1e-3)
    np.testing.assert_allclose(
        att.float().numpy(), np.asarray(att_j.astype(jnp.float32)), **tol
    )
    # the appended rows, and nothing else, changed
    row_tol = dict(rtol=1e-6, atol=1e-6) if tdt == torch.float32 else dict(rtol=2**-7, atol=0)
    for cache, before_c, cache_j in ((kc, k_before, k_j), (vc, v_before, v_j)):
        np.testing.assert_allclose(
            cache.float().numpy(), np.asarray(cache_j.astype(jnp.float32)), **row_tol
        )
        changed = (cache != before_c).any(-1).nonzero().tolist()
        assert {tuple(c) for c in changed} <= {
            (layer, b, h, p) for b, p in enumerate(pos) for h in range(KVH)
        }
    # V rows are the raw qkv rows; K rows are the rotated ones
    for b, p in enumerate(pos):
        assert torch.equal(vc[layer, b, :, p], torch.from_numpy(qkv[b, H + KVH :]).to(tdt))


def test_decode_fused_equals_rope_plus_stacked():
    """The fused form against the composed path of the port itself: rope
    outside + the stacked decode kernel's plain version (fp32)."""
    from llama2_tpu_torch.ops import ref

    L, B, H, KVH, hs, S = 2, 2, 4, 2, 64, 64
    rng = np.random.default_rng(5)
    kc = torch.from_numpy(rng.standard_normal((L, B, KVH, S, hs)).astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal((L, B, KVH, S, hs)).astype(np.float32))
    qkv = torch.from_numpy(rng.standard_normal((B, H + 2 * KVH, hs)).astype(np.float32))
    pos = torch.tensor([9, 40], dtype=torch.int32)
    cos, sin = ref.rope_angles(pos[:, None], hs)  # (B, 1, hs/2)
    q = ref.apply_rope(qkv[:, None, :H], cos, sin)
    k = ref.apply_rope(qkv[:, None, H : H + KVH], cos, sin)
    kc2, vc2 = kc.clone(), vc.clone()
    want = flash_decode_attention_stacked(
        q, kc2, vc2, k.transpose(1, 2).contiguous(), qkv[:, H + KVH :, None].contiguous(), 1, pos
    )
    got = flash_decode_attention_fused(
        qkv, kc, vc, cos[:, 0].repeat_interleave(2, -1), sin[:, 0].repeat_interleave(2, -1),
        1, pos, n_heads=H,
    )
    torch.testing.assert_close(got, want[:, 0], rtol=1e-6, atol=1e-6)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)  # rope bit-identical


@pytest.mark.parametrize(
    "bad", ["rows", "table_shape", "table_dtype", "pos_dtype", "layer", "odd_hs", "meta_device"]
)
def test_decode_fused_wrapper_rejects(bad):
    qkv = torch.zeros(2, 8, 8)
    kc, vc = torch.zeros(2, 2, 2, 16, 8), torch.zeros(2, 2, 2, 16, 8)
    cos, sin = torch.zeros(2, 8), torch.zeros(2, 8)
    layer, pos, H = 0, torch.tensor([1, 2], dtype=torch.int32), 4
    if bad == "rows":
        H = 6
    elif bad == "table_shape":
        cos = cos[:1]
    elif bad == "table_dtype":
        sin = sin.double()
    elif bad == "pos_dtype":
        pos = pos.long()
    elif bad == "layer":
        layer = 2
    elif bad == "odd_hs":
        qkv, kc, vc = torch.zeros(2, 8, 7), torch.zeros(2, 2, 2, 16, 7), torch.zeros(2, 2, 2, 16, 7)
        cos, sin = torch.zeros(2, 7), torch.zeros(2, 7)
    else:
        qkv, kc, vc, cos, sin, pos = (t.to("meta") for t in (qkv, kc, vc, cos, sin, pos))
    with pytest.raises(ValueError):
        flash_decode_attention_fused(qkv, kc, vc, cos, sin, layer, pos, n_heads=H)
