"""The torch port's FFN megakernels K10-K12 against the JAX Pallas kernels.

On the CPU the wrappers of ``llama2_tpu_torch/ops/cuda/mlp_block.py`` run
their plain PyTorch versions, which are held against ``mlp_block_stacked``,
``attn_mlp_block_stacked`` and ``layer_tail_qkv_stacked`` of
``llama2_tpu/ops/pallas/mlp_block.py`` in interpret mode on the same seeded
numpy inputs, over the shapes of ``tests/test_mlp_block.py`` (ragged hidden
and model widths, row padding, forced chunking on the JAX side).

Tolerance. Both sides round every matmul operand to bf16 and sum exact
products in float32 within a quant group, so without a flipped rounding they
differ by summation order only: most cases agree to 2e-5 abs + 1e-5 rel.
Every phase feeds the next through such a rounding, though, and two float32
values that differ in the last bit now and then round to different bf16
neighbours, which moves one product by 2^-9 |x w|: the dequant-matmul with
the rmsnorm prologue carries 5e-4 for that
(``tests/test_torch_quant_matmul.py``), and so do these (largest seen over
these cases: see PERF.md). One flipped swiglu product moves its whole output
row, so each test also requires the TIGHT bound on at least half of the
elements: a wrong phase cannot hide under the loose one.

The CUDA kernel itself is checked against the plain versions on the card by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama2_tpu.ops.pallas import mlp_block as jmb
from llama2_tpu.quant import q8 as jq
from llama2_tpu_torch.ops.cuda import mlp_block as mb
from llama2_tpu_torch.ops.cuda.quant_matmul import quant_matmul_stacked
from llama2_tpu_torch.quant import q8 as tq

EPS = 1e-5
LOOSE = dict(rtol=5e-4, atol=5e-4)  # a flipped bf16 rounding
TIGHT = dict(rtol=1e-5, atol=2e-5)  # summation order only

# (M, D, HD, G1, G2, m_cap) of tests/test_mlp_block.py::test_mlp_block_vs_oracle
K10_SHAPES = [
    (8, 256, 384, 64, 64, None),
    (1, 256, 1376, 8, 8, 2),
    (8, 2176, 256, 64, 64, None),
    (12, 256, 384, 64, 64, None),
    (8, 128, 1376, 8, 8, 1),
]
# (M, D, HD, G, m_cap) of ::test_attn_mlp_block_vs_composed
K11_SHAPES = [(8, 256, 384, 64, None), (4, 256, 1376, 8, 2)]


def both(rng, shape, G, scale=0.05):
    """The same weights quantized for each package."""
    w = rng.standard_normal(shape).astype(np.float32) * scale
    return jq.quantize(w, G), tq.quantize(w, G)


def hold(got: torch.Tensor, want, tight_share: float = 0.5) -> float:
    """``got`` within LOOSE of ``want`` everywhere and within TIGHT on at
    least ``tight_share`` of the elements; returns the largest abs error."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **LOOSE)
    err = np.abs(got - want)
    tight = err <= TIGHT["atol"] + TIGHT["rtol"] * np.abs(want)
    assert tight.mean() >= tight_share, f"only {tight.mean():.3f} of the elements within {TIGHT}"
    print(f"max_abs_err={err.max():.3e} within_tight={tight.mean():.3f}")  # shown by pytest -s
    return float(err.max())


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("M,D,HD,G1,G2,m_cap", K10_SHAPES)
def test_mlp_block_plain_vs_jax_kernel(M, D, HD, G1, G2, m_cap, layer, residual):
    rng = np.random.default_rng(D + HD + layer)
    (j1, t1), (j3, t3) = both(rng, (2, D, HD), G1), both(rng, (2, D, HD), G1)
    j2, t2 = both(rng, (2, HD, D), G2)
    rms_w = rng.standard_normal(D).astype(np.float32)
    x = rng.standard_normal((M, D)).astype(np.float32)
    assert mb.mlp_block_supported(t1, t3, t2) and jmb.mlp_block_supported(j1, j3, j2)
    want = jmb.mlp_block_stacked(jnp.asarray(x), jnp.asarray(rms_w), j1, j3, j2, layer, EPS,
                                 interpret=True, m_cap=m_cap, residual=residual)
    before = mb.mlp_block_stacked.launches
    got = mb.mlp_block_stacked(torch.from_numpy(x), torch.from_numpy(rms_w), t1, t3, t2, layer, EPS,
                               residual=residual)
    assert mb.mlp_block_stacked.launches == before  # CPU tensors: plain, no launch
    assert got.dtype == torch.float32
    hold(got, want)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("M,D,HD,G,m_cap", K11_SHAPES)
def test_attn_mlp_block_plain_vs_jax_kernel(M, D, HD, G, m_cap, layer):
    rng = np.random.default_rng(D + HD + 10 * layer)
    (j1, t1), (j3, t3) = both(rng, (2, D, HD), G), both(rng, (2, D, HD), G)
    (j2, t2), (jo, to) = both(rng, (2, HD, D), G), both(rng, (2, D, D), G)
    rms_w = rng.standard_normal(D).astype(np.float32)
    x = rng.standard_normal((M, D)).astype(np.float32)
    att = rng.standard_normal((M, D)).astype(np.float32)
    assert mb.attn_mlp_block_supported(to, t1, t3, t2)
    want = jmb.attn_mlp_block_stacked(jnp.asarray(att), jnp.asarray(x), jo, jnp.asarray(rms_w),
                                      j1, j3, j2, layer, EPS, interpret=True, m_cap=m_cap)
    before = mb.attn_mlp_block_stacked.launches
    got = mb.attn_mlp_block_stacked(torch.from_numpy(att), torch.from_numpy(x), to,
                                    torch.from_numpy(rms_w), t1, t3, t2, layer, EPS)
    assert mb.attn_mlp_block_stacked.launches == before
    hold(got, want)


def tail_inputs(rng, L, M, D, HD, Dq, G):
    ws = [both(rng, s, G) for s in ((L, D, D), (L, D, HD), (L, D, HD), (L, HD, D), (L, D, Dq))]
    rms_ffn = (1 + 0.3 * rng.standard_normal((L, D))).astype(np.float32)
    rms_att = (1 + 0.3 * rng.standard_normal((L, D))).astype(np.float32)
    x = rng.standard_normal((M, D)).astype(np.float32)
    att = rng.standard_normal((M, D)).astype(np.float32)
    return [w[0] for w in ws], [w[1] for w in ws], rms_ffn, rms_att, x, att


@pytest.mark.parametrize("layer", [0, 1, 2])  # 2 = L - 1: the next layer's index clamps
@pytest.mark.parametrize("M,D,HD,G,m_cap", K11_SHAPES)
def test_layer_tail_qkv_plain_vs_jax_kernel(M, D, HD, G, m_cap, layer):
    L, Dq = 3, 3 * D
    rng = np.random.default_rng(D + HD + 100 * layer)
    (jo, j1, j3, j2, jqkv), (to, t1, t3, t2, tqkv), rms_ffn, rms_att, x, att = tail_inputs(
        rng, L, M, D, HD, Dq, G
    )
    assert mb.layer_tail_qkv_supported(to, t1, t3, t2, tqkv)
    assert jmb.layer_tail_qkv_supported(jo, j1, j3, j2, jqkv)
    want_out, want_qkv = jmb.layer_tail_qkv_stacked(
        jnp.asarray(att), jnp.asarray(x), jo, jnp.asarray(rms_ffn), j1, j3, j2,
        jnp.asarray(rms_att), jqkv, layer, EPS, interpret=True, m_cap=m_cap,
    )
    before = mb.layer_tail_qkv_stacked.launches
    out, qkv = mb.layer_tail_qkv_stacked(
        torch.from_numpy(att), torch.from_numpy(x), to, torch.from_numpy(rms_ffn), t1, t3, t2,
        torch.from_numpy(rms_att), tqkv, layer, EPS,
    )
    assert mb.layer_tail_qkv_stacked.launches == before
    assert out.shape == (M, D) and qkv.shape == (M, Dq)
    hold(out, want_out)
    hold(qkv, want_qkv)
    # `out` is the wo + FFN megakernel's, and the clamp reads the last layer's own weights
    torch.testing.assert_close(
        out, mb.attn_mlp_block_stacked(torch.from_numpy(att), torch.from_numpy(x), to,
                                       torch.from_numpy(rms_ffn[layer]), t1, t3, t2, layer, EPS),
        rtol=0, atol=0,
    )
    nxt = min(layer + 1, L - 1)
    torch.testing.assert_close(
        qkv, quant_matmul_stacked(out, tqkv, nxt, rms_w=torch.from_numpy(rms_att[nxt]), eps=EPS),
        **LOOSE,
    )


def test_layer_tail_qkv_bf16_reads_the_f32_out():
    """bf16 activations: the next layer's QKV comes from the float32 ``out``
    inside the kernel, not from the bf16 ``out`` it returns. The port matches
    the JAX kernel (one bf16 ulp on a few outputs) and differs, on far more
    outputs, from "wo + FFN megakernel, then the rmsnorm-fused QKV launch",
    which norms the rounded ``out``."""
    L, M, D, HD, G, layer = 3, 8, 256, 384, 64, 0
    Dq = 3 * D
    rng = np.random.default_rng(5)
    js, ts, rms_ffn, rms_att, x, att = tail_inputs(rng, L, M, D, HD, Dq, G)
    (jo, j1, j3, j2, jqkv), (to, t1, t3, t2, tqkv) = js, ts
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    want_out, want_qkv = jmb.layer_tail_qkv_stacked(
        jb(att), jb(x), jo, jb(rms_ffn), j1, j3, j2, jb(rms_att), jqkv, layer, EPS, interpret=True
    )
    out, qkv = mb.layer_tail_qkv_stacked(
        tb(att), tb(x), to, tb(rms_ffn), t1, t3, t2, tb(rms_att), tqkv, layer, EPS
    )
    assert out.dtype == qkv.dtype == torch.bfloat16
    want_out = torch.from_numpy(np.asarray(want_out.astype(jnp.float32)))
    want_qkv = torch.from_numpy(np.asarray(want_qkv.astype(jnp.float32)))
    # one flip of the last bit of a bf16 output: 2^-7 of it
    torch.testing.assert_close(out.float(), want_out, rtol=2**-7, atol=1e-3)
    torch.testing.assert_close(qkv.float(), want_qkv, rtol=2**-7, atol=1e-3)
    same_as_jax = float((qkv.float() == want_qkv).float().mean())

    out11 = mb.attn_mlp_block_stacked(tb(att), tb(x), to, tb(rms_ffn[layer]), t1, t3, t2, layer, EPS)
    assert torch.equal(out11, out)
    composed = quant_matmul_stacked(out11, tqkv, layer + 1, rms_w=tb(rms_att[layer + 1]), eps=EPS)
    same_as_composed = float((qkv == composed).float().mean())
    print(f"qkv_equal_to_jax={same_as_jax:.4f} qkv_equal_to_composed={same_as_composed:.4f}")
    assert same_as_jax > 0.99, same_as_jax
    assert same_as_composed < 0.9, same_as_composed


def test_leading_dims_layers_and_rejections():
    rng = np.random.default_rng(7)
    (_, to), (_, t1), (_, t3) = both(rng, (2, 128, 128), 32), both(rng, (2, 128, 96), 32), both(rng, (2, 128, 96), 32)
    (_, t2), (_, tqkv) = both(rng, (2, 96, 128), 16), both(rng, (2, 128, 160), 64)
    rms = torch.from_numpy(rng.standard_normal((2, 128)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((4, 1, 128)).astype(np.float32))
    att = torch.from_numpy(rng.standard_normal((4, 1, 128)).astype(np.float32))
    # leading dims flatten into rows; every layer is its own weight
    out, qkv = mb.layer_tail_qkv_stacked(att, x, to, rms, t1, t3, t2, rms, tqkv, 0)
    assert out.shape == (4, 1, 128) and qkv.shape == (4, 1, 160)
    flat = mb.layer_tail_qkv_stacked(att[:, 0], x[:, 0], to, rms, t1, t3, t2, rms, tqkv, 0)
    assert torch.equal(out[:, 0], flat[0]) and torch.equal(qkv[:, 0], flat[1])
    other = mb.layer_tail_qkv_stacked(att, x, to, rms, t1, t3, t2, rms, tqkv, 1)
    assert not torch.allclose(out, other[0])
    assert torch.equal(
        mb.mlp_block_stacked(x, rms[1], t1, t3, t2, 1),
        x + mb.mlp_block_stacked(x, rms[1], t1, t3, t2, 1, residual=False),
    )

    # what the predicates refuse, the wrappers raise on
    assert mb.mlp_block_supported(t1, t3, t2) and mb.attn_mlp_block_supported(to, t1, t3, t2)
    assert mb.layer_tail_qkv_supported(to, t1, t3, t2, tqkv)
    assert not mb.mlp_block_supported(t1[0], t3, t2)  # 2-D (unstacked)
    assert not mb.mlp_block_supported(t1, t3, to)  # w2 of the wrong shape
    assert not mb.mlp_block_supported(t1, tq.QuantTensor(t3.q, t3.scale.repeat_interleave(2, -2), 16), t2)
    assert not mb.mlp_block_supported(t1, t3, tq.QuantTensor(t2.q, t2.scale, 36))  # HD % G2
    assert not mb.mlp_block_supported(t1, t3, t2.q)  # not quantized
    assert not mb.attn_mlp_block_supported(t1, t1, t3, t2)  # wo not (L, D, D)
    assert not mb.attn_mlp_block_supported(to.q.float(), t1, t3, t2)  # an fp wo
    assert not mb.layer_tail_qkv_supported(to, t1, t3, t2, tqkv[:1])
    wide = tq.quantize(np.ones((2, 256, 256), np.float32), 256)
    assert not mb.attn_mlp_block_supported(wide, wide, wide, wide)  # groups past 128
    with pytest.raises(ValueError):
        mb.mlp_block_stacked(x, rms[0], t1[0], t3, t2, 0)
    with pytest.raises(ValueError):
        mb.attn_mlp_block_stacked(att, x, to.q.float(), rms[0], t1, t3, t2, 0)
    with pytest.raises(ValueError):
        mb.layer_tail_qkv_stacked(att, x, to, rms, t1, t3, t2, rms, tqkv[:1], 0)
    with pytest.raises(ValueError):
        mb.mlp_block_stacked(x, rms[0], t1, t3, t2, 2)  # layer out of range
    with pytest.raises(ValueError):
        mb.mlp_block_stacked(x[..., :64], rms[0], t1, t3, t2, 0)  # rows of the wrong width
    with pytest.raises(ValueError):  # a scale that does not match its values
        mb.mlp_block_stacked(x, rms[0], t1, t3, tq.QuantTensor(t2.q, t2.scale[:, :3], 16), 0)
    with pytest.raises(ValueError):  # no silent plain version for another device
        mb.mlp_block_stacked(x.to("meta"), rms[0], t1, t3, t2, 0)


def test_kernel_plan_covers_the_7b_shapes():
    """One launch at Llama-2-7B widths on 396 resident blocks (three an SM):
    every phase splits its contraction over whole rounds of a block's 8 warps
    so that its items about fill the grid once, never more."""
    D, HD, Dq, G = 4096, 11008, 12288, 64
    for blocks in (132, 264, 396):
        p = mb.plan(1, D, HD, Dq, (G, G, G, G), blocks)
        assert p["mt"] == 1
        for ks, (K, N, nmat) in zip(p["ksplit"], ((D, D, 1), (D, HD, 2), (HD, D, 1), (D, Dq, 1))):
            items = nmat * -(-N // 128) * ks
            assert 1 <= ks <= K // G // 8
            assert items <= blocks or ks == 1
            assert items > blocks // 2
        partial = max(p["ksplit"][0] * D, 2 * p["ksplit"][1] * HD, p["ksplit"][2] * D, p["ksplit"][3] * Dq)
        assert p["ws_floats"] == 3 * D + HD + partial
    assert mb.plan(1, D, HD, Dq, (G, G, G, G), 396)["ksplit"] == (8, 2, 11, 4)
    # without the wo and qkv phases their splits are 0; rows pick the tile
    p = mb.plan(12, D, HD, 0, (0, G, G, 0), 132)
    assert p["mt"] == 8 and p["ksplit"][0] == p["ksplit"][3] == 0
    assert [mb.row_tile(m) for m in (1, 2, 3, 4, 5, 8, 12)] == [1, 2, 4, 4, 8, 8, 8]
    assert mb.plan(1, 64, 172, 96, (16, 16, 4, 16), 396)["ksplit"] == (1, 1, 6, 1)  # a tiny model
