"""The split arithmetic of the fp32 prefill segment's tensor-core kernels,
emulated in plain PyTorch on the CPU and held against the JAX kernels (in
interpret mode, as the JAX package's tests run them) at the card's unchanged
bounds, before any card runs them:

* K1's tf32 variant (``csrc/prefill_attention.cu``, ``prefill_tf32_kernel``):
  both products as three TF32 passes, a b = a_hi b_hi + a_hi b_lo + a_lo b_hi
  with a_hi = tf32(a), a_lo = tf32(a - a_hi) (cvt.rna: nearest, ties away),
  q scaled in float32 before its split, P split too, and a short segment's
  keys cut into runs merged in order; 2e-5.
* K5/K6's accurate M > 8 tile (``csrc/quant_matmul.cu``, PLANES = 3): x cut
  into three bf16 planes, each group's products of all three planes summed
  in float32, times the group's scale, the groups summed in order; 4e-5.

The emulations live here only: the port's plain versions stay the float32
functions the kernels are held to on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from llama2_tpu.ops.pallas.prefill_attention import flash_prefill_attention as jax_k1
from llama2_tpu.ops.pallas.quant_matmul import quant_matmul_stacked as jax_k6
from llama2_tpu.quant import q8 as jq

from llama2_tpu_torch.ops.cuda import quant_matmul as qm
from llama2_tpu_torch.quant import q8 as tq

LAYOUTS = {"7B": (32, 32, 128), "GQA": (32, 4, 64), "stories15M": (6, 6, 48)}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: float32 rounded to 10 explicit mantissa bits, to
    nearest with ties away from zero (a half unit added to the magnitude's
    bits, then the low 13 bits cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's three TF32 passes, each product exact in float32
    (11 x 11 bits) and summed in float32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def k1_tf32_emulated(q, k, v, pos: int) -> torch.Tensor:
    """K1's tf32 variant on float32 (B, T, H, hs) q and (B, KVH, S, hs)
    caches: scores (q * scale) . k in three passes, the causal softmax's
    float32 weights p = exp(s - max), o = (p @ v in three passes) / sum(p)."""
    B, T, H, hs = q.shape
    KVH = k.shape[1]
    n = pos + T
    qs = (q.float() * (1.0 / hs**0.5)).permute(0, 2, 1, 3)  # (B, H, T, hs)
    kk = k[:, :, :n].float().repeat_interleave(H // KVH, dim=1)
    vv = v[:, :, :n].float().repeat_interleave(H // KVH, dim=1)
    s = mm3(qs, kk.transpose(-1, -2))
    mask = torch.arange(n)[None, :] > (pos + torch.arange(T))[:, None]
    s = s.masked_fill(mask, -torch.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = mm3(p, vv) / p.sum(-1, keepdim=True)
    return o.permute(0, 2, 1, 3)


def k1_tf32_runs_emulated(q, k, v, pos: int, splits: int, keys: int) -> torch.Tensor:
    """The tf32 variant with its keys cut over ``splits`` blocks, as the
    kernel cuts them: the ``keys``-key tiles up to the segment's last
    position in runs of cdiv(tiles, splits), the last ones possibly empty;
    each run's unnormalized (o, m, l) in float32, merged in run order."""
    B, T, H, hs = q.shape
    KVH = k.shape[1]
    n = pos + T
    qs = (q.float() * (1.0 / hs**0.5)).permute(0, 2, 1, 3)
    kk = k[:, :, :n].float().repeat_interleave(H // KVH, dim=1)
    vv = v[:, :, :n].float().repeat_interleave(H // KVH, dim=1)
    mask = torch.arange(n)[None, :] > (pos + torch.arange(T))[:, None]
    tiles = -(-n // keys)
    per = -(-tiles // splits)
    runs = []
    for r in range(splits):
        a, b = min(n, r * per * keys), min(n, (r * per + per) * keys)
        s = mm3(qs, kk[:, :, a:b].transpose(-1, -2)).masked_fill(mask[:, a:b], -torch.inf)
        m = s.amax(-1, keepdim=True) if b > a else torch.full((*s.shape[:-1], 1), -torch.inf)
        p = torch.exp(s - torch.where(m == -torch.inf, 0.0, m))
        runs.append((mm3(p, vv[:, :, a:b]), m, p.sum(-1, keepdim=True)))
    mt = torch.stack([m for _, m, _ in runs]).amax(0)  # finite: run 0 holds key 0
    o = sum(o * torch.exp(m - mt) for o, m, _ in runs)
    l = sum(l * torch.exp(m - mt) for _, m, l in runs)
    return (o / l).permute(0, 2, 1, 3)


def bf16_planes(x: torch.Tensor):
    """prep_x_kernel's planes of a float32 x: hi = bf16(x), mid = bf16(x -
    hi), lo = bf16(x - hi - mid), each difference taken in float32."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def accurate_tile_emulated(x, q, scale, G: int, rms_w=None, eps=1e-5, res=None) -> torch.Tensor:
    """The accurate M > 8 tile on float32 x (M, K), int8 q (K, N): the
    prologue's norm in float32, x in three bf16 planes, each group's products
    of the three planes summed in float32 (exact products: 8 x 8 bits), the
    group's partial times its scale, the groups added in order."""
    K, N = q.shape
    xf = x.float() if rms_w is None else qm.norm_rows(x, rms_w, eps)
    qg = q.float().reshape(K // G, G, N)
    part = sum(torch.bmm(p.float().reshape(-1, K // G, G).transpose(0, 1), qg) for p in bf16_planes(xf))
    acc = torch.zeros(x.shape[0], N)
    for g in range(K // G):
        acc = acc + part[g] * scale[g]
    return acc if res is None else acc + res.float()


def test_bf16_planes_hold_x_to_2_pow_minus_24():
    """hi + mid + lo is x to 2^-24 |x| over thirty decades, and each plane
    holds what the one above it left (|mid| <= 2^-8 |hi|, |lo| <= 2^-8 |mid|)."""
    g = np.random.default_rng(10)
    x = torch.from_numpy((g.standard_normal(20000) * 10.0 ** g.uniform(-15, 15, 20000)).astype(np.float32))
    hi, mid, lo = bf16_planes(x)
    back = hi.double() + mid.double() + lo.double()
    assert bool(((back - x.double()).abs() <= 2.0**-24 * x.double().abs()).all())
    assert bool((mid.double().abs() <= 2.0**-8 * hi.double().abs()).all())
    assert bool((lo.double().abs() <= 2.0**-8 * mid.double().abs()).all())


def test_tf32_split_holds_x_to_2_pow_minus_22():
    """tf32 keeps 10 explicit mantissa bits, rounded to nearest, ties away;
    hi + lo is x to 2^-22 |x|; one TF32 alone is off by up to 2^-11 |x|."""
    assert float(tf32(torch.tensor([1.0 + 2.0**-11]))) == 1.0 + 2.0**-10  # a tie, away from zero
    assert float(tf32(torch.tensor([-(1.0 + 2.0**-11)]))) == -(1.0 + 2.0**-10)
    assert float(tf32(torch.tensor([1.0 + 2.0**-12]))) == 1.0
    g = np.random.default_rng(11)
    x = torch.from_numpy((g.standard_normal(20000) * 10.0 ** g.uniform(-10, 10, 20000)).astype(np.float32))
    hi, lo = split_tf32(x)
    xd = x.double()
    assert bool(((hi.double() + lo.double() - xd).abs() <= 2.0**-22 * xd.abs()).all())
    one = (hi.double() - xd).abs() / xd.abs()
    assert float(one.max()) <= 2.0**-11 and float(one.max()) > 2.0**-12


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("T,pos", [(1, 0), (2, 0), (7, 13), (16, 40)])
def test_k1_tf32_split_vs_jax(layout, T, pos):
    """The tf32 variant's arithmetic against the JAX kernel in interpret mode
    (Precision.HIGHEST) at the card's fp32 bound, 2e-5, on the three head
    layouts narrowed to two KV heads, short segments included."""
    H, KVH, hs = LAYOUTS[layout]
    H, KVH = 2 * H // KVH, 2
    g = np.random.default_rng(100 * T + pos + hs)
    S = 64
    q = g.standard_normal((1, T, H, hs)).astype(np.float32)
    k = g.standard_normal((1, KVH, S, hs)).astype(np.float32)
    v = g.standard_normal((1, KVH, S, hs)).astype(np.float32)
    want = np.asarray(jax_k1(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, interpret=True))
    got = k1_tf32_emulated(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("T,pos,splits", [(5, 123, 9), (5, 2, 9), (1, 0, 16), (16, 100, 4)])
def test_k1_tf32_key_runs_vs_jax(T, pos, splits):
    """The tf32 variant's keys cut over blocks (a verify window's plan: its
    32-key tiles in runs, empty runs at short positions) and merged in run
    order, against the JAX kernel in interpret mode at 2e-5."""
    g = np.random.default_rng(7 * T + pos)
    H, KVH, hs, S = 4, 2, 128, 128
    q = g.standard_normal((1, T, H, hs)).astype(np.float32)
    k = g.standard_normal((1, KVH, S, hs)).astype(np.float32)
    v = g.standard_normal((1, KVH, S, hs)).astype(np.float32)
    want = np.asarray(jax_k1(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, interpret=True))
    got = k1_tf32_runs_emulated(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos,
                                splits, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_one_tf32_pass_misses_the_fp32_bound():
    """The split is needed: with one TF32 pass of each product the same
    emulation misses 2e-5 against the JAX kernel at the 7B head size."""
    g = np.random.default_rng(12)
    H, KVH, hs, S, T, pos = 2, 2, 128, 64, 16, 40
    q = g.standard_normal((1, T, H, hs)).astype(np.float32)
    k = g.standard_normal((1, KVH, S, hs)).astype(np.float32)
    v = g.standard_normal((1, KVH, S, hs)).astype(np.float32)
    want = np.asarray(jax_k1(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, interpret=True))
    qt, kt, vt = (tf32(torch.from_numpy(a)) for a in (q, k, v))
    qs = tf32(qt * (1.0 / hs**0.5)).permute(0, 2, 1, 3)
    s = qs @ kt[:, :, : pos + T].transpose(-1, -2)
    s = s.masked_fill(torch.arange(pos + T)[None, :] > (pos + torch.arange(T))[:, None], -torch.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    one = ((tf32(p) @ vt[:, :, : pos + T]) / p.sum(-1, keepdim=True)).permute(0, 2, 1, 3)
    err = np.abs(one.numpy() - want) - (2e-5 + 2e-5 * np.abs(want))
    assert err.max() > 0


@pytest.mark.parametrize("M,G,norm,resid", [(9, 8, True, False), (64, 64, False, True),
                                            (130, 32, True, True), (201, 64, False, False)])
def test_accurate_tile_planes_vs_jax(M, G, norm, resid):
    """The accurate M > 8 tile's arithmetic (three bf16 planes, the scale
    factored out of each group) against the JAX kernel in accurate mode,
    interpret mode, at the card's fp32 bound, 4e-5: past the decode rows, at
    one and past one 128-row tile, with and without the rmsnorm prologue and
    the residual epilogue."""
    g = np.random.default_rng(M + G)
    L, K, N = 2, 256, 96
    w = g.standard_normal((L, K, N)).astype(np.float32) * 0.05
    jt, tt = jq.quantize(w, G), tq.quantize(w, G)
    x = (g.standard_normal((M, K)) * 3).astype(np.float32)
    rms_w = g.standard_normal(K).astype(np.float32) if norm else None
    res = g.standard_normal((M, N)).astype(np.float32) if resid else None
    want = np.asarray(jax_k6(jnp.asarray(x), jt, 1, interpret=True, mode="accurate",
                             rms_w=None if rms_w is None else jnp.asarray(rms_w), eps=1e-5,
                             residual=None if res is None else jnp.asarray(res)))
    got = accurate_tile_emulated(torch.from_numpy(x), tt.q[1], tt.scale[1], G,
                                 None if rms_w is None else torch.from_numpy(rms_w), 1e-5,
                                 None if res is None else torch.from_numpy(res))
    np.testing.assert_allclose(got.numpy(), want, rtol=4e-5, atol=4e-5)


def test_accurate_tile_with_one_plane_is_fast_mode_on_bf16_rows():
    """A bf16 x with no prologue is one exact plane: the accurate tile's
    arithmetic is then fast mode's (``fast_accum``), bit for bit, which is
    why the wrapper launches it with one plane."""
    g = np.random.default_rng(13)
    K, N, G, M = 256, 64, 32, 40
    t = tq.quantize((g.standard_normal((K, N)) * 0.05).astype(np.float32), G)
    x = torch.from_numpy(g.standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16).float()
    assert [float(p.float().abs().max()) for p in bf16_planes(x)[1:]] == [0.0, 0.0]
    assert qm.x_planes("accurate", torch.bfloat16, None) == 1
    assert torch.equal(accurate_tile_emulated(x, t.q, t.scale, G), qm.fast_accum(x, t.q, t.scale, G))
