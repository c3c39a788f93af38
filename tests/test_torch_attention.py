"""The torch port's attention kernels K1/K2 against the JAX Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions, which are held
against ``flash_prefill_attention`` and ``flash_decode_attention_stacked`` of
``llama2_tpu/ops/pallas`` in interpret mode, on the shape lists of
``tests/test_pallas_kernels.py`` with its tolerance (rtol/atol 2e-5). K2 also
checks the in-place append: only rows ``[layer, b, :, pos_b]`` change. The
CUDA kernels themselves are checked against the plain versions on the card
by ``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama2_tpu.ops.pallas.attention import flash_decode_attention_stacked as jax_k2
from llama2_tpu.ops.pallas.prefill_attention import flash_prefill_attention as jax_k1
from llama2_tpu_torch.ops.cuda.attention import flash_decode_attention_stacked
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
