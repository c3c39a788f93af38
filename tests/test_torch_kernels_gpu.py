"""Card-only tests of the torch port: the CUDA kernels against their plain
versions, and generation on the card against generation on the CPU.

They carry the ``gpu`` marker and skip without a CUDA device; one test
without it checks on the CPU that the int8-cache attention tolerance fails
planted faults. This file imports no JAX, so it also runs where JAX is
absent:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from llama2_tpu_torch.config import GenerationConfig, ModelConfig
from llama2_tpu_torch.io.convert import random_params, random_q8_params
from llama2_tpu_torch.ops.cuda.attention import (
    flash_decode_attention_fused,
    flash_decode_attention_fused_plain,
    flash_decode_attention_stacked,
    flash_decode_attention_stacked_plain,
)
from llama2_tpu_torch.ops.cuda import mlp_block as mb
from llama2_tpu_torch.ops.cuda.prefill_attention import (
    flash_prefill_attention,
    flash_prefill_attention_plain,
)
from llama2_tpu_torch.ops.cuda.quant_matmul import (
    quant_matmul,
    quant_matmul_plain,
    quant_matmul_stacked,
    quant_matmul_stacked_plain,
)
from llama2_tpu_torch.quant.q8 import QuantTensor
from llama2_tpu_torch.runtime.generator import Generator


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(cuda_device, dtype):
    """Both CUDA kernels against their plain versions on the card, at the
    Llama-2-7B head layout; fp32 to 2e-5, bf16 to one last-bit flip. K1 runs
    its tensor-core variant of the dtype: mma for bf16, tf32 for fp32."""
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-3)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    H, hs, S = 32, 128, 1024

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    k, v, q = randn(1, H, S, hs), randn(1, H, S, hs), randn(1, 77, H, hs)
    variant = "launches_tf32" if dtype == torch.float32 else "launches_mma"
    n1, n_var = flash_prefill_attention.launches, getattr(flash_prefill_attention, variant)
    got = flash_prefill_attention(q, k, v, 100)
    assert flash_prefill_attention.launches == n1 + 1
    assert getattr(flash_prefill_attention, variant) == n_var + 1
    torch.testing.assert_close(got, flash_prefill_attention_plain(q, k, v, 100), **tol)

    kc, vc = randn(2, 1, H, S, hs), randn(2, 1, H, S, hs)
    kn, vn, q1 = randn(1, H, 1, hs), randn(1, H, 1, hs), randn(1, 1, H, hs)
    pos = torch.tensor([700], dtype=torch.int32, device=cuda_device)
    kp, vp = kc.clone(), vc.clone()
    n2 = flash_decode_attention_stacked.launches
    got = flash_decode_attention_stacked(q1, kc, vc, kn, vn, 1, pos)
    assert flash_decode_attention_stacked.launches == n2 + 1
    want = flash_decode_attention_stacked_plain(q1, kp, vp, kn, vn, 1, pos)
    torch.testing.assert_close(got, want, **tol)
    assert torch.equal(kc, kp) and torch.equal(vc, vp)


@pytest.mark.gpu
def test_generate_on_card_matches_cpu(cuda_device):
    """fp32 greedy generation through the kernels on the card gives the CPU
    plain path's tokens on a small GQA model (head size 48)."""
    config = ModelConfig(dim=192, hidden_dim=512, n_layers=3, n_heads=4, n_kv_heads=2,
                         vocab_size=512, seq_len=128)
    params = random_params(config, 3, "cpu", torch.float32, scale=0.08)
    gen = GenerationConfig(temperature=0.0, steps=60)
    prompt = [5, 17, 320, 9, 44, 2, 100]
    want = Generator(config, params, device="cpu").generate(prompt, gen, prefill_chunk=3)
    n1, n2 = flash_prefill_attention.launches, flash_decode_attention_stacked.launches
    got = Generator(config, params, device=cuda_device).generate(prompt, gen, prefill_chunk=3)
    assert got.tokens == want.tokens
    assert flash_prefill_attention.launches > n1 and flash_decode_attention_stacked.launches > n2


def _assert_close(got, want, tol, what):
    err = (got.float() - want.float()).abs()
    bound = tol["atol"] + tol["rtol"] * want.float().abs()
    assert bool(torch.isfinite(got.float()).all()), what
    atol = tol["atol"]
    if isinstance(atol, torch.Tensor):
        atol = f"{float(atol.min()):.3e}..{float(atol.max()):.3e}"
    assert bool((err <= bound).all()), f"{what}: max abs err {float(err.max()):.3e} past rtol={tol['rtol']} atol={atol}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["accurate", "fast"])
def test_quant_matmul_kernels_match_plain_on_card(cuda_device, dtype, mode):
    """K5 and K6 against their plain versions at the Llama-2-7B projection
    shapes: decode rows (M = 1, 3, 8), a prefill chunk (M = 201), layers 0 and
    1 of a stack, with and without the rmsnorm prologue and the residual
    epilogue; M = 201 counted on the M > 8 tile of its mode (accurate: x in
    three bf16 planes, or one for bf16 rows with no prologue). fp32 outputs: 4e-5 (the float32 rounding of sums over K = 4096
    and 11008 taken in another order; 2.2e-5 seen), 1e-3 in fast mode with the
    prologue
    (a last-bit difference of the normed x can flip its bf16 rounding, which
    moves one product by 2^-8 |x| |w|, up to 7e-4 at |x| = 4 and the largest
    weight here; 6.4e-4 seen); bf16 outputs: one last-bit flip,
    1e-3 + 2^-7 |x|."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    G = 64

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    def weights(*shape):
        q = torch.randint(-127, 128, shape, generator=g, device=cuda_device, dtype=torch.int8)
        sshape = (*shape[:-2], shape[-2] // G, shape[-1])
        scale = 2.7e-4 * (0.7 + 0.6 * torch.rand(sshape, generator=g, device=cuda_device))
        return QuantTensor(q, scale, G)

    def tol(norm):
        if dtype == torch.bfloat16:
            return dict(rtol=2**-7, atol=1e-3)
        return dict(rtol=1e-3, atol=1e-3) if norm and mode == "fast" else dict(rtol=4e-5, atol=4e-5)

    for K, N in ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)):
        w = weights(2, K, N)
        for M in (1, 3, 8, 201):
            x, rms_w, res = randn(M, K), 1 + 0.1 * randn(K), randn(M, N)
            for layer, norm, resid in ((0, False, False), (1, True, False), (1, False, True), (0, True, True)):
                kw = dict(mode=mode, rms_w=rms_w if norm else None, residual=res if resid else None)
                n0 = quant_matmul_stacked.launches
                n_tile = getattr(quant_matmul_stacked, f"launches_tile_{mode}")
                got = quant_matmul_stacked(x, w, layer, **kw)
                assert quant_matmul_stacked.launches == n0 + 1
                assert getattr(quant_matmul_stacked, f"launches_tile_{mode}") == n_tile + (M > 8)
                want = quant_matmul_stacked_plain(x, w, layer, **kw)
                torch.cuda.synchronize()
                assert got.dtype == dtype and got.shape == (M, N)
                _assert_close(got, want, tol(norm), f"K6 {K}x{N} M={M} layer={layer} {norm=} {resid=}")
        del w
    w = weights(4096, 32000)
    for M in (1, 8, 201):
        x = randn(2, M, 4096)[1:]  # a lead dim and a storage offset
        n0 = quant_matmul.launches
        got = quant_matmul(x, w, mode=mode)
        assert quant_matmul.launches == n0 + 1
        _assert_close(got, quant_matmul_plain(x, w, mode=mode), tol(False), f"K5 M={M}")
    # a narrow model: group size 16 and 4, N not a multiple of 16, tiny K
    w = QuantTensor(
        torch.randint(-127, 128, (3, 172, 72), generator=g, device=cuda_device, dtype=torch.int8),
        torch.rand((3, 43, 72), generator=g, device=cuda_device) * 1e-3, 4,
    )
    for M in (1, 2, 5, 40):
        x, rms_w, res = randn(M, 172), 1 + 0.1 * randn(172), randn(M, 72)
        got = quant_matmul_stacked(x, w, 2, mode=mode, rms_w=rms_w, residual=res)
        want = quant_matmul_stacked_plain(x, w, 2, mode=mode, rms_w=rms_w, residual=res)
        _assert_close(got, want, tol(True), f"K6 narrow M={M}")
    # the same launch twice gives the same bits (no float atomics)
    x = randn(1, 4096)
    w = weights(1, 4096, 4096)
    assert torch.equal(quant_matmul_stacked(x, w, 0, mode=mode), quant_matmul_stacked(x, w, 0, mode=mode))
    with pytest.raises(ValueError):
        quant_matmul_stacked(x, w, 1, mode=mode)
    with pytest.raises(ValueError):
        quant_matmul_stacked(x, w, 0, mode=mode, residual=randn(1, 4096).double())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_decode_kernel_matches_plain_on_card(cuda_device, dtype):
    """K4 against its plain version at three head layouts, a per-row batch and
    the cache's ends; the appended rows equal bit for bit."""
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-3)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    S, L, layer = 4096, 2, 1

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    from llama2_tpu_torch.ops import ref

    for H, KVH, hs in ((32, 32, 128), (32, 4, 64), (6, 6, 48)):
        for pos_list in ([0], [1000], [S - 1], [7, 1000, S - 1]):
            B = len(pos_list)
            kc, vc = randn(L, B, KVH, S, hs), randn(L, B, KVH, S, hs)
            kp, vp = kc.clone(), vc.clone()
            qkv = randn(B, H + 2 * KVH, hs)
            pos = torch.tensor(pos_list, dtype=torch.int32, device=cuda_device)
            cos, sin = ref.rope_angles(pos[:, None], hs)
            cos_il = cos[:, 0].repeat_interleave(2, -1).contiguous()
            sin_il = sin[:, 0].repeat_interleave(2, -1).contiguous()
            n0 = flash_decode_attention_fused.launches
            got = flash_decode_attention_fused(qkv, kc, vc, cos_il, sin_il, layer, pos, n_heads=H)
            assert flash_decode_attention_fused.launches == n0 + 1
            want = flash_decode_attention_fused_plain(qkv, kp, vp, cos_il, sin_il, layer, pos, H)
            torch.cuda.synchronize()
            _assert_close(got, want, tol, f"K4 {H=} {KVH=} {hs=} pos={pos_list}")
            assert torch.equal(kc, kp) and torch.equal(vc, vp)


@pytest.mark.gpu
def test_q8_generate_on_card_matches_cpu(cuda_device):
    """fp32 greedy Q8 generation on the card through ``cuda-accurate`` (K6
    accurate + K2 + K1 + K5) gives the CPU plain path's tokens, and the
    ``cuda`` path launches K4, K5 and K6."""
    config = ModelConfig(dim=256, hidden_dim=704, n_layers=3, n_heads=4, n_kv_heads=2,
                         vocab_size=512, seq_len=128)
    params = random_q8_params(config, 3, "cpu", torch.float32, group_size=64)
    for k, v in params.items():  # widen the scales: logits with clear margins
        if isinstance(v, QuantTensor):
            params[k] = QuantTensor(v.q, v.scale * 4, v.group_size)
    gen = GenerationConfig(temperature=0.0, steps=60)
    prompt = [5, 17, 320, 9, 44, 2, 100]
    want = Generator(config, params, backend="torch", device="cpu").generate(prompt, gen, prefill_chunk=3)
    got = Generator(config, params, backend="cuda-accurate", device=cuda_device).generate(
        prompt, gen, prefill_chunk=3
    )
    assert got.tokens == want.tokens
    n4, n5, n6 = (f.launches for f in (flash_decode_attention_fused, quant_matmul, quant_matmul_stacked))
    n11, n12 = mb.attn_mlp_block_stacked.launches, mb.layer_tail_qkv_stacked.launches
    fast = Generator(config, params, backend="cuda", device=cuda_device).generate(prompt, gen)
    assert fast.tokens[: len(prompt)] == prompt and len(fast.tokens) > len(prompt)
    assert flash_decode_attention_fused.launches > n4
    assert quant_matmul.launches > n5 and quant_matmul_stacked.launches > n6
    # the 2-launch decode layer: one K11 and L - 1 = 2 K12 launches a step
    steps = mb.attn_mlp_block_stacked.launches - n11
    assert steps >= len(fast.tokens) - len(prompt) > 0
    assert mb.layer_tail_qkv_stacked.launches - n12 == 2 * steps


def _q8_stack(g, device, L, K, N, G, factor=1.0):
    q = torch.randint(-127, 128, (L, K, N), generator=g, device=device, dtype=torch.int8)
    scale = factor * 2.7e-4 * (0.7 + 0.6 * torch.rand((L, K // G, N), generator=g, device=device))
    return QuantTensor(q, scale, G)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_block_kernels_match_plain_on_card(cuda_device, dtype):
    """K10, K11, K12 against their plain versions: the Llama-2-7B widths and
    two ragged shapes (HD = 1376 = 172 * 8, D = 2176 = 17 * 128), 1 to 12 rows,
    layers 0, L-2 and L-1 (K12's next-layer index clamps), K10 with and
    without the residual. Each call is one launch and repeats bit for bit.

    Tolerance: the kernel and the plain version sum in another order, and
    every operand of the next matmul is rounded to bf16, so a value on a
    rounding boundary goes the other way now and then (2^-8 |x| times a
    weight, for the whole output row; at HD = 11008 a few times a call): 2e-3
    of the largest |want|, where a dropped quant group would show as ~1e-1 of
    it. bf16 outputs add one flip of the last bit."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    L = 4

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    def hold(got, want, what):
        tol = dict(rtol=2e-5 if dtype == torch.float32 else 2**-7,
                   atol=2e-3 * float(want.float().abs().max()))
        _assert_close(got, want, tol, what)

    def once(wrapper, *args, **kw):
        n0 = wrapper.launches
        a, b = wrapper(*args, **kw), wrapper(*args, **kw)
        assert wrapper.launches == n0 + 2
        for u, v in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert torch.equal(u, v), f"{wrapper.__name__}: bits differ on the same inputs"
        return a

    for D, HD, Dq, G, factor in ((4096, 11008, 12288, 64, 1.0), (256, 1376, 384, 8, 2.0),
                                 (2176, 256, 2304, 64, 2.0)):
        wo, w1, w3 = (_q8_stack(g, cuda_device, L, D, n, G, factor) for n in (D, HD, HD))
        w2, wqkv = _q8_stack(g, cuda_device, L, HD, D, G, factor), _q8_stack(g, cuda_device, L, D, Dq, G, factor)
        rms_ffn, rms_att = 1 + 0.1 * randn(L, D), 1 + 0.1 * randn(L, D)
        for M in (1, 3, 8, 12):
            x, att = randn(2, M, D)[1], randn(M, D)  # a storage offset
            for layer in (0, L - 2, L - 1):
                what = f"{D=} {HD=} {M=} {layer=}"
                for residual in (True, False):
                    got = once(mb.mlp_block_stacked, x, rms_ffn[layer], w1, w3, w2, layer, residual=residual)
                    hold(got, mb.mlp_block_plain(x, rms_ffn[layer], w1, w3, w2, layer, residual=residual),
                         f"K10 {what} {residual=}")
                got = once(mb.attn_mlp_block_stacked, att, x, wo, rms_ffn[layer], w1, w3, w2, layer)
                hold(got, mb.attn_mlp_block_plain(att, x, wo, rms_ffn[layer], w1, w3, w2, layer), f"K11 {what}")
                out, qkv = once(mb.layer_tail_qkv_stacked, att, x, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, layer)
                want = mb.layer_tail_qkv_plain(att, x, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, layer)
                torch.cuda.synchronize()
                assert out.shape == (M, D) and qkv.shape == (M, Dq) and out.dtype == qkv.dtype == dtype
                hold(out, want[0], f"K12 out {what}")
                hold(qkv, want[1], f"K12 qkv {what}")
        del wo, w1, w3, w2, wqkv


@pytest.mark.gpu
def test_mlp_block_wrappers_raise_on_card_and_do_not_fall_back(cuda_device):
    """On a CUDA tensor a wrapper launches its kernel or raises: what the
    kernel does not take (a width not divisible by 4, quant groups past 128, a
    dtype other than fp32 and bf16, a tensor on another device) is a
    ValueError, never the plain version or the composed route."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((1, 256), generator=g, device=cuda_device)
    rms = torch.ones(256, device=cuda_device)
    ok = [_q8_stack(g, cuda_device, 2, k, n, 64) for k, n in ((256, 384), (256, 384), (384, 256))]
    before = mb.mlp_block_stacked.launches
    assert mb.mlp_block_stacked(x, rms, *ok, 0).shape == (1, 256)
    assert mb.mlp_block_stacked.launches == before + 1
    odd = [_q8_stack(g, cuda_device, 2, k, n, 2) for k, n in ((256, 386), (256, 386), (386, 256))]
    wide = [_q8_stack(g, cuda_device, 2, k, n, 256) for k, n in ((256, 512), (256, 512), (512, 256))]
    for bad in (odd, wide):
        assert not mb.mlp_block_supported(*bad)
        with pytest.raises(ValueError):
            mb.mlp_block_stacked(x, rms, *bad, 0)
    with pytest.raises(ValueError):
        mb.mlp_block_stacked(x.double(), rms.double(), *ok, 0)
    with pytest.raises(ValueError):
        mb.mlp_block_stacked(x, rms.cpu(), *ok, 0)
    with pytest.raises(ValueError):
        mb.mlp_block_stacked(x, rms.bfloat16(), *ok, 0)
    assert mb.mlp_block_stacked.launches == before + 1


def _int8_cache(g, device, *shape):
    from llama2_tpu_torch.ops.cuda.attention_q8 import quantize_kv_rows

    k8, ks = quantize_kv_rows(torch.randn(shape, generator=g, device=device))
    v8, vs = quantize_kv_rows(torch.randn(shape, generator=g, device=device))
    return [k8, ks, v8, vs]


def _q8kv_terms(q4, k8, ks, v8, vs, horizon, weight=None):
    """The plain int8-cache attention of q4 (B, T, H, hs) over one layer's
    cache, row t of batch b seeing keys 0..horizon[b, t], each key's p times
    ``weight`` (S,) where given (a planted fault). Returns float32 (out, A,
    R), each (B, T, H, hs): A = sum_t w_t |v_t|, R = sqrt(sum_t w_t^2 v_t^2),
    w the softmax weights and v the dequantized values."""
    B, T, H, hs = q4.shape
    KVH = k8.shape[1]
    n = int(horizon.max()) + 1
    qb = q4.to(torch.bfloat16).float().reshape(B, T, KVH, H // KVH, hs)
    s = torch.einsum("btkgd,bksd->bkgts", qb, k8[:, :, :n].float())
    s = s * (ks[:, :, None, None, :n] * (1.0 / hs**0.5))
    visible = torch.arange(n, device=q4.device)[None, None, :] <= horizon[:, :, None]
    s = s.masked_fill(~visible[:, None, None], float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if weight is not None:
        p = p * weight[:n]
    l = p.sum(dim=-1, keepdim=True)
    pv = (p * vs[:, :, None, None, :n]).to(torch.bfloat16).float()
    v = v8[:, :, :n].float()
    out = torch.einsum("bkgts,bksd->bkgtd", pv, v) / l
    w, vd = p / l, v * vs[:, :, :n, None]
    A = torch.einsum("bkgts,bksd->bkgtd", w, vd.abs())
    R = torch.einsum("bkgts,bksd->bkgtd", w * w, vd * vd).sqrt()
    return tuple(t.permute(0, 3, 1, 2, 4).reshape(B, T, H, hs) for t in (out, A, R))


def _q8kv_tol(dtype, q4, k8, ks, v8, vs, horizon, shape=lambda t: t):
    """The int8-cache attention kernels against their plain versions, element
    by element: both round each term ``p * v_scale`` to bf16, p taken against
    the running maximum in the kernel and the row's maximum in the plain
    version, so the two roundings of a term differ by at most 2^-7 of it
    (2^-7 A in all), and over many keys, independent and of mean 0, their sum
    passes 2^-4 R with probability under 1e-13 (Hoeffding). The atol is the
    smaller, plus 2^-16 A for the float32 steps. fp32 outputs rtol 2e-5 on
    top, bf16 outputs one flip of the last bit. ``shape`` takes (B, T, H, hs)
    to the output's shape."""
    _, A, R = _q8kv_terms(q4, k8, ks, v8, vs, horizon)
    atol = torch.minimum(2**-7 * A, 2**-4 * R) + 2**-16 * A
    return dict(rtol=2e-5 if dtype == torch.float32 else 2**-7, atol=shape(atol))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q8kv_tolerance_fails_planted_faults(dtype):
    """At pos 4095 the int8-cache tolerance passes the plain version's own
    output recomputed, and fails it with one 32-key chunk dropped, one
    256-key split dropped, or that split's weight doubled in the merge."""
    from llama2_tpu_torch.ops.cuda import attention_q8 as aq

    g = torch.Generator().manual_seed(11)
    S, H, KVH, hs = 4096, 4, 4, 128
    k8, ks = aq.quantize_kv_rows(torch.randn((1, KVH, S, hs), generator=g))
    v8, vs = aq.quantize_kv_rows(torch.randn((1, KVH, S, hs), generator=g))
    q = torch.randn((1, 1, H, hs), generator=g).to(dtype)
    horizon = torch.tensor([[S - 1]])
    want = aq.flash_decode_attention_q8_plain(q, k8, ks, v8, vs, S - 1)
    tol = _q8kv_tol(dtype, q, k8, ks, v8, vs, horizon)
    _assert_close(_q8kv_terms(q, k8, ks, v8, vs, horizon)[0].to(dtype), want, tol, "plain recomputed")
    for first, end, factor in ((2048, 2080, 0.0), (1024, 1280, 0.0), (1024, 1280, 2.0)):
        weight = torch.ones(S)
        weight[first:end] = factor
        bad = _q8kv_terms(q, k8, ks, v8, vs, horizon, weight)[0].to(dtype)
        with pytest.raises(AssertionError):
            _assert_close(bad, want, tol, f"keys {first}..{end} times {factor}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_cache_attention_kernels_match_plain_on_card(cuda_device, dtype):
    """K7 (T = 1, 4, 16), K8 and K9 against their plain versions at the
    Llama-2-7B and a GQA head layout, a batch of two rows at their own
    positions; the appended bytes and scales equal the plain version's, and
    a second run of each call gives the same bits."""
    from llama2_tpu_torch.ops import ref
    from llama2_tpu_torch.ops.cuda import attention_q8 as aq

    g = torch.Generator(device=cuda_device).manual_seed(6)
    S, L = 4096, 3

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    for H, KVH, hs in ((32, 32, 128), (32, 4, 64)):
        k8, ks, v8, vs = _int8_cache(g, cuda_device, 2, KVH, S, hs)
        for T in (1, 4, 16):
            for p0 in (T - 1, 127, S - 1):
                pos = torch.tensor([p0, max(T - 1, p0 // 2)], dtype=torch.int32, device=cuda_device)
                q = randn(2, T, H, hs)
                n0 = aq.flash_decode_attention_q8.launches
                got = aq.flash_decode_attention_q8(q, k8, ks, v8, vs, pos)
                assert aq.flash_decode_attention_q8.launches == n0 + 1
                assert torch.equal(got, aq.flash_decode_attention_q8(q, k8, ks, v8, vs, pos))
                horizon = pos.long()[:, None] - (T - 1) + torch.arange(T, device=cuda_device)[None, :]
                tol = _q8kv_tol(dtype, q, k8, ks, v8, vs, horizon)
                _assert_close(got, aq.flash_decode_attention_q8_plain(q, k8, ks, v8, vs, pos), tol,
                              f"K7 {H=} {KVH=} {T=} {p0=}")
        caches = _int8_cache(g, cuda_device, L, 2, KVH, S, hs)
        for layer in (0, L - 1):
            for pos_list in ([0, 5], [127, S - 1]):
                pos = torch.tensor(pos_list, dtype=torch.int32, device=cuda_device)
                q = randn(2, H, hs)
                kn, ksn = aq.quantize_kv_rows(randn(2, KVH, 1, hs).float())
                vn, vsn = aq.quantize_kv_rows(randn(2, KVH, 1, hs).float())
                runs = [[t.clone() for t in caches] for _ in range(3)]
                n0 = aq.flash_decode_attention_q8_stacked.launches
                got = [aq.flash_decode_attention_q8_stacked(q, *c, kn, ksn, vn, vsn, layer, pos) for c in runs[:2]]
                assert aq.flash_decode_attention_q8_stacked.launches == n0 + 2
                want = aq.flash_decode_attention_q8_stacked_plain(q, *runs[2], kn, ksn, vn, vsn, layer, pos)
                assert torch.equal(got[0], got[1])
                at_layer = [t[layer] for t in runs[2]]
                tol = _q8kv_tol(dtype, q[:, None], *at_layer, pos.long()[:, None], lambda t: t[:, 0])
                _assert_close(got[0], want, tol, f"K8 {H=} {KVH=} {layer=} {pos_list=}")
                assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(*runs))

                qkv = randn(2, H + 2 * KVH, hs)
                cos, sin = ref.rope_angles(pos[:, None], hs)
                cos_il = cos[:, 0].repeat_interleave(2, -1).contiguous()
                sin_il = sin[:, 0].repeat_interleave(2, -1).contiguous()
                runs = [[t.clone() for t in caches] for _ in range(3)]
                n0 = aq.flash_decode_attention_q8_fused.launches
                got = [aq.flash_decode_attention_q8_fused(qkv, *c, cos_il, sin_il, layer, pos, n_heads=H)
                       for c in runs[:2]]
                assert aq.flash_decode_attention_q8_fused.launches == n0 + 2
                want = aq.flash_decode_attention_q8_fused_plain(qkv, *runs[2], cos_il, sin_il, layer, pos, H)
                assert torch.equal(got[0], got[1])
                q_rot = aq.rope_quantize_plain(qkv, cos_il, sin_il, H)[0]
                tol = _q8kv_tol(dtype, q_rot[:, None], *[t[layer] for t in runs[2]], pos.long()[:, None],
                                lambda t: t[:, 0])
                _assert_close(got[0], want, tol, f"K9 {H=} {KVH=} {layer=} {pos_list=}")
                assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(*runs))
        del caches


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_block_kernel_matches_plain_on_card(cuda_device, dtype):
    """K13 at the Llama-2-7B widths, with and without the qkv phase, at pos 0
    (only this step's row), 256 and 4095: within 1e-2 of the largest |want|
    of its plain version and within 2e-2 of it of K9 + K12 (the bound of
    tests/test_layer_block.py; the two differ in how this step's row joins
    and in the rounding of att), bf16 outputs one flip of the last bit more;
    its appends equal to both bit for bit, and the same bits on a second
    run."""
    from llama2_tpu_torch.ops import ref
    from llama2_tpu_torch.ops.cuda import attention_q8 as aq
    from llama2_tpu_torch.ops.cuda import layer_block as lb

    g = torch.Generator(device=cuda_device).manual_seed(7)
    H, KVH, hs, L, S = 32, 32, 128, 2, 4096
    D, HD = H * hs, 11008
    wo, w1, w3 = (_q8_stack(g, cuda_device, L, D, n, 64) for n in (D, HD, HD))
    w2, wqkv = _q8_stack(g, cuda_device, L, HD, D, 64), _q8_stack(g, cuda_device, L, D, (H + 2 * KVH) * hs, 64)
    rms_ffn = (1 + 0.1 * torch.randn((L, D), generator=g, device=cuda_device)).to(dtype)
    rms_att = (1 + 0.1 * torch.randn((L, D), generator=g, device=cuda_device)).to(dtype)
    caches = _int8_cache(g, cuda_device, L, 1, KVH, S, hs)
    for p in (0, 256, S - 1):
        pos = torch.tensor([p], dtype=torch.int32, device=cuda_device)
        cos, sin = ref.rope_angles(pos[:, None], hs)
        cos_il = cos[:, 0].repeat_interleave(2, -1).contiguous()
        sin_il = sin[:, 0].repeat_interleave(2, -1).contiguous()
        qkv3 = torch.randn((1, H + 2 * KVH, hs), generator=g, device=cuda_device).to(dtype)
        x = torch.randn((1, D), generator=g, device=cuda_device).to(dtype)
        for with_qkv in (True, False):
            layer = 0 if with_qkv else L - 1
            args = (cos_il, sin_il, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, layer, pos)
            runs = [[t.clone() for t in caches] for _ in range(4)]
            n0 = lb.layer_block_stacked.launches
            got = [lb.layer_block_stacked(qkv3, x, *c, *args, n_heads=H, with_qkv=with_qkv) for c in runs[:2]]
            assert lb.layer_block_stacked.launches == n0 + 2
            want = lb.layer_block_stacked_plain(qkv3, x, *runs[2], *args, n_heads=H, with_qkv=with_qkv)
            att = aq.flash_decode_attention_q8_fused(qkv3, *runs[3], cos_il, sin_il, layer, pos, n_heads=H)
            if with_qkv:
                pair = mb.layer_tail_qkv_stacked(att.reshape(1, D), x, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, layer)
            else:
                pair = (mb.attn_mlp_block_stacked(att.reshape(1, D), x, wo, rms_ffn[layer], w1, w3, w2, layer), None)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d) for a, b, c, d in zip(*runs))
            for i in range(2 if with_qkv else 1):
                assert torch.equal(got[0][i], got[1][i])
                scale = float(want[i].float().abs().max())
                rtol = 0.0 if dtype == torch.float32 else 2**-7  # bf16: one flip of the last bit
                _assert_close(got[0][i], want[i], dict(rtol=rtol, atol=1e-2 * scale), f"K13 vs plain {p=} {i=}")
                _assert_close(got[0][i], pair[i], dict(rtol=rtol, atol=2e-2 * scale), f"K13 vs K9+K12 {p=} {i=}")
            if not with_qkv:
                assert got[0][1] is None


@pytest.mark.gpu
def test_int8_cache_wrappers_raise_on_card_and_do_not_fall_back(cuda_device):
    """On a CUDA tensor the int8-cache wrappers launch or raise: a window
    past 16 rows, an unported dtype, an odd head size, new rows of the wrong
    dtype, weights the whole-layer kernel does not take are ValueErrors, and
    no refused call counts a launch."""
    from llama2_tpu_torch.ops.cuda import attention_q8 as aq
    from llama2_tpu_torch.ops.cuda import layer_block as lb

    g = torch.Generator(device=cuda_device).manual_seed(8)
    k8, ks, v8, vs = _int8_cache(g, cuda_device, 1, 2, 64, 16)
    counts = (aq.flash_decode_attention_q8.launches, aq.flash_decode_attention_q8_stacked.launches,
              lb.layer_block_stacked.launches)
    q = torch.randn((1, 17, 4, 16), generator=g, device=cuda_device)
    for bad in (q, q[:, :2].double(), q[:, :2, :, :15].contiguous()):
        kk, vv = (k8, v8) if bad.shape[-1] == 16 else (k8[..., :15].contiguous(), v8[..., :15].contiguous())
        with pytest.raises(ValueError):
            aq.flash_decode_attention_q8(bad, kk, ks, vv, vs, 20)
    stack = [t[None] for t in (k8, ks, v8, vs)]
    pos = torch.tensor([20], dtype=torch.int32, device=cuda_device)
    rows = aq.quantize_kv_rows(torch.randn((1, 2, 1, 16), generator=g, device=cuda_device))
    with pytest.raises(ValueError):  # float32 rows where int8 rows belong
        aq.flash_decode_attention_q8_stacked(q[:, 0], *stack, rows[0].float(), rows[1], rows[0], rows[1], 0, pos)
    wide = [_q8_stack(g, cuda_device, 1, 64, n, 8) for n in (64, 128, 128)]
    w2, wqkv = _q8_stack(g, cuda_device, 1, 128, 64, 8), _q8_stack(g, cuda_device, 1, 64, 96, 8)

    class Cfg:  # two query heads of 16 do not span the width 64
        n_heads, n_kv_heads, head_size = 2, 2, 16

    assert not lb.layer_block_supported(wide[0], wide[1], wide[2], w2, wqkv, Cfg)
    with pytest.raises(ValueError):
        lb.layer_block_stacked(torch.randn((1, 6, 16), generator=g, device=cuda_device),
                               torch.randn((1, 64), generator=g, device=cuda_device), *stack,
                               torch.ones((1, 16), device=cuda_device), torch.zeros((1, 16), device=cuda_device),
                               wide[0], torch.ones((1, 64), device=cuda_device), wide[1], wide[2], w2,
                               torch.ones((1, 64), device=cuda_device), wqkv, 0, pos, n_heads=2)
    # the split loop's 2-byte instance takes rows off 16-byte alignment; an
    # odd address is refused
    odd = [_offset(t) for t in (k8, ks, v8, vs)]
    for bad in (odd, [odd[0], ks, _offset(v8), vs]):
        with pytest.raises(ValueError):
            aq.flash_decode_attention_q8(q[:, :4], *bad, 20)
    with pytest.raises(ValueError):
        aq.flash_decode_attention_q8_stacked(q[:, 0], *[_offset(t) for t in stack], *rows, *rows, 0, pos)
    assert counts == (aq.flash_decode_attention_q8.launches, aq.flash_decode_attention_q8_stacked.launches,
                      lb.layer_block_stacked.launches)
    # the new instances launch (and count) where they take the operands: a
    # 12-row window in two row groups, and rows 2 bytes off 16-byte alignment
    two = [buf[2:].view(t.shape).copy_(t) for t, buf in
           ((t, torch.empty(t.numel() + 2, dtype=t.dtype, device=cuda_device)) for t in (k8, v8))]
    for kk, vv, T in ((k8, v8, 12), (two[0], two[1], 4)):
        n0 = aq.flash_decode_attention_q8.launches
        aq.flash_decode_attention_q8(q[:, :T], kk, ks, vv, vs, 20)
        assert aq.flash_decode_attention_q8.launches == n0 + 1


@pytest.mark.gpu
def test_kv_quant_and_speculative_generate_on_card(cuda_device):
    """fp32 greedy Q8 generation over the int8 cache through
    ``cuda-accurate`` (K8) gives the CPU plain path's tokens on a small model
    with clear logit margins; with ``speculative=4`` (verify windows through
    K7) the card gives the same tokens again, and the ``cuda`` path runs the
    whole-layer kernel (K13) a layer per step."""
    from llama2_tpu_torch.ops.cuda import attention_q8 as aq
    from llama2_tpu_torch.ops.cuda import layer_block as lb

    config = ModelConfig(dim=256, hidden_dim=704, n_layers=3, n_heads=2, n_kv_heads=2,
                         vocab_size=512, seq_len=128)
    params = random_q8_params(config, 3, "cpu", torch.float32, group_size=64)
    for k, v in params.items():  # widen the scales: logits with clear margins
        if isinstance(v, QuantTensor):
            params[k] = QuantTensor(v.q, v.scale * 4, v.group_size)
    gen = GenerationConfig(temperature=0.0, steps=60)
    prompt = [5, 17, 320, 9, 44, 2, 100]
    want = Generator(config, params, backend="cuda-accurate", device="cpu", kv_quant=True).generate(prompt, gen)
    n7, n8 = aq.flash_decode_attention_q8.launches, aq.flash_decode_attention_q8_stacked.launches
    got = Generator(config, params, backend="cuda-accurate", device=cuda_device, kv_quant=True).generate(prompt, gen)
    assert got.tokens == want.tokens
    assert aq.flash_decode_attention_q8.launches > n7 and aq.flash_decode_attention_q8_stacked.launches > n8
    n7 = aq.flash_decode_attention_q8.launches
    spec = Generator(config, params, backend="cuda-accurate", device=cuda_device, kv_quant=True,
                     speculative=4).generate(prompt, gen)
    assert spec.tokens == want.tokens and spec.spec_trips > 0
    assert aq.flash_decode_attention_q8.launches - n7 >= spec.spec_trips * config.n_layers
    n13 = lb.layer_block_stacked.launches
    fast = Generator(config, params, dtype=torch.bfloat16, backend="cuda", device=cuda_device,
                     kv_quant=True).generate(prompt, gen)
    steps = len(fast.tokens) - len(prompt)
    assert steps > 0 and lb.layer_block_stacked.launches - n13 >= config.n_layers * steps


def _paged_setup(g, device, pos_list, page, n_inactive, S):
    """A (B, S // page) int32 table for ``pos_list`` (the last ``n_inactive``
    rows all zero: the scratch page), the active slots' pages handed out in
    a shuffled order of 1.., and the write coordinates; returns (table,
    write_page, write_row, pos, pool pages)."""
    B = len(pos_list)
    need = [p // page + 1 for p in pos_list[: B - n_inactive]]
    n_pages = sum(need) + 1
    perm = (torch.randperm(n_pages - 1, generator=g) + 1).tolist()
    table = torch.zeros((B, S // page), dtype=torch.int32)
    at = 0
    for b, n in enumerate(need):
        table[b, :n] = torch.tensor(perm[at : at + n], dtype=torch.int32)
        at += n
    table = table.to(device)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=device)
    wpage = table[torch.arange(B, device=device), (pos // page).long()].contiguous()
    return table, wpage, (pos % page).contiguous(), pos, n_pages


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_match_plain_on_card(cuda_device, dtype):
    """K15 and K17 over fp pools, K16 and K18 over int8 pools, against their
    plain versions: 8 slots (positions 0, page - 1, page, a mid-page row,
    S - 1 and another; two inactive slots on the scratch page), shuffled
    pages of 256 and 128 rows, the 7B and a GQA head layout, the last layer
    of a 2-layer pool. The active slots' outputs within the fp tolerance, or
    the int8-cache one; the pools equal to the plain version's; one launch
    a call and the same bits on a rerun."""
    from llama2_tpu_torch.ops import ref
    from llama2_tpu_torch.ops.cuda import attention_q8 as aq
    from llama2_tpu_torch.ops.cuda import paged_attention as tpa

    g = torch.Generator(device=cuda_device).manual_seed(12)
    cpu_g = torch.Generator().manual_seed(12)
    S, L, act = 2048, 2, 6
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-3)

    def randn(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=cuda_device).to(dt)

    def twice_then_plain(wrapper, plain, pre, pools, post, kw):
        runs = [[t.clone() for t in pools] for _ in range(2)]
        n0 = wrapper.launches
        got = [wrapper(*pre, *c, *post, **kw)[0] for c in runs]
        assert wrapper.launches == n0 + 2
        want = plain(*pre, *pools, *post, **kw)[0]
        torch.cuda.synchronize()
        assert torch.equal(got[0][:act], got[1][:act]) and torch.isfinite(got[0].float()).all()
        assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(*runs, pools))
        return got[0], want

    for H, KVH, hs in ((32, 32, 128), (32, 4, 64)):
        for page in (256, 128):
            pos_list = [0, page - 1, page, 1000, S - 1, page // 2 + 3, 5, 9]
            table, wpage, wrow, pos, P = _paged_setup(cpu_g, cuda_device, pos_list, page, 2, S)
            cos, sin = ref.rope_angles(pos[:, None], hs)
            cos_il = cos[:, 0].repeat_interleave(2, -1).contiguous()
            sin_il = sin[:, 0].repeat_interleave(2, -1).contiguous()
            q, qkv = randn(8, H, hs), randn(8, H + 2 * KVH, hs)
            coords = (wpage, wrow, L - 1, pos)
            fp = [randn(L, P, KVH, page, hs), randn(L, P, KVH, page, hs)]
            kn, vn = randn(8, KVH, 1, hs), randn(8, KVH, 1, hs)
            got, want = twice_then_plain(tpa.paged_decode_attention_stacked, tpa.paged_decode_attention_stacked_plain,
                                         (q,), fp, (table, kn, vn, *coords), {})
            _assert_close(got[:act], want[:act], tol, f"K15 {H=} {KVH=} {page=}")
            got, want = twice_then_plain(tpa.paged_decode_attention_fused, tpa.paged_decode_attention_fused_plain,
                                         (qkv,), fp, (table, cos_il, sin_il, *coords), {"n_heads": H})
            _assert_close(got[:act], want[:act], tol, f"K17 {H=} {KVH=} {page=}")
            del fp
            q8 = _int8_cache(g, cuda_device, L, P, KVH, page, hs)
            k8n, ksn = aq.quantize_kv_rows(randn(8, KVH, 1, hs, dt=torch.float32))
            v8n, vsn = aq.quantize_kv_rows(randn(8, KVH, 1, hs, dt=torch.float32))
            n = (S - 1) // page + 1
            for wrapper, plain, pre, post, kw, qt in (
                (tpa.paged_decode_attention_q8_stacked, tpa.paged_decode_attention_q8_stacked_plain, (q,),
                 (table, k8n, ksn, v8n, vsn, *coords), {}, q),
                (tpa.paged_decode_attention_q8_fused, tpa.paged_decode_attention_q8_fused_plain, (qkv,),
                 (table, cos_il, sin_il, *coords), {"n_heads": H}, aq.rope_quantize_plain(qkv, cos_il, sin_il, H)[0]),
            ):
                pools = [t.clone() for t in q8]
                got, want = twice_then_plain(wrapper, plain, pre, pools, post, kw)
                dense = [tpa.gather_pages(t[L - 1], table, n)[:act] for t in pools]
                t8 = _q8kv_tol(dtype, qt[:act, None], *dense, pos.long()[:act, None], lambda t: t[:, 0])
                _assert_close(got[:act], want[:act], t8, f"{wrapper.__name__} {H=} {KVH=} {page=}")
            del q8


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_at_8_rows_match_plain_on_card(cuda_device, dtype):
    """The batched engines run K4, K9 and K13 at 8 rows, each at its own
    position: against their plain versions at their tolerances (K13 to 1e-2
    of the largest output, with and without the qkv phase), appends equal."""
    from llama2_tpu_torch.ops import ref
    from llama2_tpu_torch.ops.cuda import attention_q8 as aq
    from llama2_tpu_torch.ops.cuda import layer_block as lb

    g = torch.Generator(device=cuda_device).manual_seed(13)
    H, KVH, hs, L, S = 32, 32, 128, 2, 4096
    pos = torch.tensor([0, 255, 256, 1000, S - 1, 77, 3000, 2047], dtype=torch.int32, device=cuda_device)
    B = pos.shape[0]
    cos, sin = ref.rope_angles(pos[:, None], hs)
    cos_il = cos[:, 0].repeat_interleave(2, -1).contiguous()
    sin_il = sin[:, 0].repeat_interleave(2, -1).contiguous()
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-3)
    qkv = torch.randn((B, H + 2 * KVH, hs), generator=g, device=cuda_device).to(dtype)
    kc = torch.randn((L, B, KVH, S, hs), generator=g, device=cuda_device).to(dtype)
    vc = torch.randn((L, B, KVH, S, hs), generator=g, device=cuda_device).to(dtype)
    k1, v1 = kc.clone(), vc.clone()
    got = flash_decode_attention_fused(qkv, k1, v1, cos_il, sin_il, 1, pos, n_heads=H)
    want = flash_decode_attention_fused_plain(qkv, kc, vc, cos_il, sin_il, 1, pos, H)
    _assert_close(got, want, tol, "K4 at 8 rows")
    assert torch.equal(k1, kc) and torch.equal(v1, vc)
    del kc, vc, k1, v1
    caches = _int8_cache(g, cuda_device, L, B, KVH, S, hs)
    c1 = [t.clone() for t in caches]
    got = aq.flash_decode_attention_q8_fused(qkv, *c1, cos_il, sin_il, 1, pos, n_heads=H)
    want = aq.flash_decode_attention_q8_fused_plain(qkv, *caches, cos_il, sin_il, 1, pos, H)
    assert all(torch.equal(a, b) for a, b in zip(c1, caches))
    q_rot = aq.rope_quantize_plain(qkv, cos_il, sin_il, H)[0]
    t8 = _q8kv_tol(dtype, q_rot[:, None], *[t[1] for t in caches], pos.long()[:, None], lambda t: t[:, 0])
    _assert_close(got, want, t8, "K9 at 8 rows")
    D, HD = H * hs, 11008
    wo, w1, w3 = (_q8_stack(g, cuda_device, L, D, n, 64) for n in (D, HD, HD))
    w2, wqkv = _q8_stack(g, cuda_device, L, HD, D, 64), _q8_stack(g, cuda_device, L, D, (H + 2 * KVH) * hs, 64)
    rms_ffn = (1 + 0.1 * torch.randn((L, D), generator=g, device=cuda_device)).to(dtype)
    rms_att = (1 + 0.1 * torch.randn((L, D), generator=g, device=cuda_device)).to(dtype)
    x = torch.randn((B, D), generator=g, device=cuda_device).to(dtype)
    for with_qkv in (True, False):
        layer = 0 if with_qkv else L - 1
        args = (cos_il, sin_il, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, layer, pos)
        c1, c2 = [t.clone() for t in caches], [t.clone() for t in caches]
        got = lb.layer_block_stacked(qkv, x, *c1, *args, n_heads=H, with_qkv=with_qkv)
        want = lb.layer_block_stacked_plain(qkv, x, *c2, *args, n_heads=H, with_qkv=with_qkv)
        assert all(torch.equal(a, b) for a, b in zip(c1, c2))
        rtol = 0.0 if dtype == torch.float32 else 2**-7
        for i in range(2 if with_qkv else 1):
            scale = float(want[i].float().abs().max())
            _assert_close(got[i], want[i], dict(rtol=rtol, atol=1e-2 * scale), f"K13 at 8 rows {with_qkv=} {i=}")


@pytest.mark.gpu
def test_paged_engine_on_card_matches_cpu(cuda_device):
    """The paged engine on the card against the same engine on the CPU (the
    plain versions), fp32 greedy, Q8 weights, ``cuda-accurate`` (K15 or K16
    a layer): the card's logits with the CPU's tokens forced on it, within
    1e-3 over an fp pool, where the tokens must be the CPU's, and within
    3e-2 of the largest logit over an int8 pool, where they must be the
    CPU's wherever its top-2 margin exceeds twice that distance (the int8
    kernels round ``p * v_scale`` to bf16 against another running maximum
    than the plain version: PERF.md section 2's rules). ``cuda`` then runs
    the glue-fused paged kernels (K17, K18) a layer per decode tick."""
    from llama2_tpu_torch.ops.cuda import paged_attention as tpa
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

    config = ModelConfig(dim=256, hidden_dim=704, n_layers=3, n_heads=2, n_kv_heads=2,
                         vocab_size=512, seq_len=256)
    params = random_q8_params(config, 4, "cpu", torch.float32, group_size=64)
    for k, v in params.items():  # widen the scales: logits with clear margins
        if isinstance(v, QuantTensor):
            params[k] = QuantTensor(v.q, v.scale * 4, v.group_size)
    gen = GenerationConfig(temperature=0.0, steps=60)
    prompts = [[5, 17, 320, 9], [7], [44, 2, 100, 3, 8, 11]]

    def serve(device, backend, kv_quant, dtype=torch.float32, forced=None):
        """Tokens and every request's logits rows; with ``forced`` (the
        streams to follow), the samplers return those streams' tokens."""
        eng = PagedBatchEngine(config, params, batch_size=2, page_size=32, n_pages=24, backend=backend,
                               device=device, kv_quant=kv_quant, dtype=dtype, pipeline_depth=1)
        log, sample, first = {}, eng._sample, eng._sample_first

        def nxt(req, n):
            toks = forced[tuple(req.prompt)]
            return toks[n] if n < len(toks) else 1

        def logged(logits, sampled, draws):
            for b, r in enumerate(eng.slots):
                if r is not None:
                    log[tuple(r.prompt)].append(logits[b].float().cpu())
            if forced is None:
                return sample(logits, sampled, draws)
            return torch.tensor([0 if r is None else nxt(r, len(r.tokens)) for r in eng.slots],
                                dtype=torch.int32, device=logits.device)

        def logged_first(logits, req, pos):
            log[tuple(req.prompt)] = [logits.float().cpu()]
            return first(logits, req, pos) if forced is None else nxt(req, len(req.prompt))

        eng._sample, eng._sample_first = logged, logged_first
        qs = [eng.submit(p, gen) for p in prompts]
        eng.run_until_idle()
        return [q.get(timeout=300).tokens for q in qs], {k: torch.stack(v) for k, v in log.items()}

    for kv_quant in (False, True):
        want, lw = serve("cpu", "cuda-accurate", kv_quant)
        wrapper = tpa.paged_decode_attention_q8_stacked if kv_quant else tpa.paged_decode_attention_stacked
        n0 = wrapper.launches
        forced = {tuple(p): t for p, t in zip(prompts, want)}
        toks, lg = serve(cuda_device, "cuda-accurate", kv_quant, forced=forced)
        assert toks == want and wrapper.launches > n0
        dist = max(float((lw[k] - lg[k]).abs().max()) for k in lw)
        absmax = max(float(v.abs().max()) for v in lw.values())
        if not kv_quant:
            assert dist <= 1e-3, dist
            assert serve(cuda_device, "cuda-accurate", kv_quant)[0] == want
        else:
            assert dist <= 3e-2 * absmax, (dist, absmax)
            for p, t in zip(prompts, want):
                top2 = lw[tuple(p)].topk(2, dim=-1).values
                clear = (top2[:, 0] - top2[:, 1]) > 2 * dist
                n = len(t) - len(p)
                agree = lg[tuple(p)][:n].argmax(-1) == torch.tensor(t[len(p):])
                assert bool(agree[clear[:n]].all()), p
        fused = tpa.paged_decode_attention_q8_fused if kv_quant else tpa.paged_decode_attention_fused
        n0 = fused.launches
        got = serve(cuda_device, "cuda", kv_quant, torch.bfloat16)[0]
        assert all(len(t) > len(p) for t, p in zip(got, prompts))
        assert fused.launches - n0 >= config.n_layers * max(len(t) - len(p) - 1 for t, p in zip(got, prompts))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_read_only_decode_kernels_match_plain_on_card(cuda_device, dtype):
    """K3 over one layer's dense caches (per-row positions 0, 300 and S - 1,
    and an int position) and K14 over one layer's shuffled pools, whose
    table names a NaN-filled page past each row's last page (the plain
    version, which gathers the longest row's page count for every row, gets
    valid pages there): outputs within the fp tolerance and finite, one
    launch a call, the caches and pools untouched. Both run the split form:
    a rerun gives the same bits and leaves every ticket zero; a given scale
    is taken; and more (b, query head) pairs than the workspace has tickets
    take one split and launch."""
    from llama2_tpu_torch.ops.cuda import attention as fa
    from llama2_tpu_torch.ops.cuda import paged_attention as tpa

    g = torch.Generator(device=cuda_device).manual_seed(13)
    cpu_g = torch.Generator().manual_seed(13)
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-3)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    S = 1024
    for H, KVH, hs in ((32, 32, 128), (32, 4, 64), (6, 6, 48)):
        k, v = randn(3, KVH, S, hs), randn(3, KVH, S, hs)
        k0, v0 = k.clone(), v.clone()
        for q, pos in ((randn(3, 1, H, hs), torch.tensor([0, 300, S - 1], dtype=torch.int32, device=cuda_device)),
                       (randn(3, H, hs), 700)):
            for scale in (None, 0.3):
                n0 = fa.flash_decode_attention.launches
                got = fa.flash_decode_attention(q, k, v, pos, scale=scale)
                assert fa.flash_decode_attention.launches == n0 + 1
                want = fa.flash_decode_attention_plain(q, k, v, pos, scale=scale)
                torch.cuda.synchronize()
                assert got.shape == q.shape and got.dtype == dtype
                _assert_close(got, want, tol, f"K3 {H=} {KVH=} {hs=} {scale=}")
                assert torch.equal(got, fa.flash_decode_attention(q, k, v, pos, scale=scale))
                assert _tickets_zero(cuda_device)
        assert torch.equal(k, k0) and torch.equal(v, v0)

        page = 128
        pos_list = [0, page - 1, page, 1000, S - 1, 77, 5, 9]
        table, _, _, pos, P = _paged_setup(cpu_g, cuda_device, pos_list, page, 0, S)
        kp, vp = randn(P + 1, KVH, page, hs), randn(P + 1, KVH, page, hs)
        kp[P], vp[P] = float("nan"), float("nan")  # the page past every row's last
        used = torch.arange(table.shape[1], device=cuda_device)[None] <= (pos // page)[:, None]
        nan_table = torch.where(used, table, torch.full_like(table, P))
        q = randn(8, H, hs)
        kp0 = kp.clone()
        n0 = tpa.paged_decode_attention.launches
        got = tpa.paged_decode_attention(q, kp, vp, nan_table, pos)
        assert tpa.paged_decode_attention.launches == n0 + 1
        want = tpa.paged_decode_attention_plain(q, kp, vp, table, pos)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        _assert_close(got, want, tol, f"K14 {H=} {KVH=} {hs=}")
        assert torch.equal(got, tpa.paged_decode_attention(q, kp, vp, nan_table, pos))
        assert _tickets_zero(cuda_device)
        got = tpa.paged_decode_attention(q, kp, vp, nan_table, pos, scale=0.3)
        _assert_close(got, tpa.paged_decode_attention_plain(q, kp, vp, table, pos, scale=0.3), tol,
                      f"K14 {H=} {KVH=} {hs=} scale=0.3")
        assert torch.equal(kp.nan_to_num(), kp0.nan_to_num())

    # B * H past the workspace's tickets: one split, no ticket, any B * H
    from llama2_tpu_torch.ops.cuda import build

    H, KVH, hs, S, page = 32, 4, 64, 40, 8
    B = build.MAX_TICKETS // H + 3
    pos = torch.randint(0, S, (B,), generator=cpu_g, dtype=torch.int32).to(cuda_device)
    k, v, q = randn(B, KVH, S, hs), randn(B, KVH, S, hs), randn(B, H, hs)
    got = fa.flash_decode_attention(q, k, v, pos)
    _assert_close(got, fa.flash_decode_attention_plain(q, k, v, pos), tol, f"K3 {B=} {H=}")
    table = torch.arange(B * S // page, dtype=torch.int32, device=cuda_device).reshape(B, S // page)
    kp, vp = (t.reshape(B, KVH, S // page, page, hs).transpose(1, 2).reshape(-1, KVH, page, hs).contiguous()
              for t in (k, v))
    got = tpa.paged_decode_attention(q, kp, vp, table, pos)
    _assert_close(got, fa.flash_decode_attention_plain(q, k, v, pos), tol, f"K14 {B=} {H=}")
    assert _tickets_zero(cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_and_swiglu_kernels_match_plain_on_card(cuda_device, dtype):
    """K19 and K20 against their plain versions at the JAX tests' ragged
    widths (288, 64, 172; 768, 64, 172; no 16-byte vectors for some), the
    benchmark widths and K19's tier edges, each launch in the form its plan
    names, the output in the rows' dtype. K19 in bf16 is held to
    two last-bit steps (it rounds twice, and its float32 sum of squares is
    taken in another order than the plain version's); the rest to the
    kernels' usual tolerance."""
    from llama2_tpu_torch.ops.cuda.rmsnorm import plan as rms_plan
    from llama2_tpu_torch.ops.cuda.rmsnorm import rmsnorm, rmsnorm_plain
    from llama2_tpu_torch.ops.cuda.swiglu import swiglu, swiglu_plain

    g = torch.Generator(device=cuda_device).manual_seed(14)
    f32 = dtype == torch.float32
    tol = dict(rtol=2e-5, atol=2e-5) if f32 else dict(rtol=2**-7, atol=1e-3)
    norm_tol = tol if f32 else dict(rtol=2**-6, atol=1e-3)

    def randn(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=cuda_device).to(dt)

    # the register form's tier edges (rmsnorm.plan: 32-256 threads a row, 8
    # vectors a thread): a full tier and one vector past it in each dtype, a
    # row too long for any tier (the loop form), a ragged one (scalar)
    edges = ((3, 1024), (1, 1028), (1, 4096), (3, 4100), (1, 8196), (3, 2048), (1, 2056),
             (3, 16384), (1, 16392), (3, 4098))
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for shape in ((1, 1, 288), (2, 7, 64), (1, 300, 172), (256, 4096), (3, 8192)) + edges:
        x = randn(*shape)
        form = "launches_" + rms_plan(x.numel() // shape[-1], shape[-1], dtype, True, sms)["form"]
        for w in (1 + 0.1 * randn(shape[-1]), 1 + 0.1 * randn(shape[-1], dt=torch.float32)):
            n0, n_form = rmsnorm.launches, getattr(rmsnorm, form)
            got = rmsnorm(x, w)
            assert rmsnorm.launches == n0 + 1 and got.dtype == dtype and got.shape == x.shape
            assert getattr(rmsnorm, form) == n_form + 1, f"K19 {shape}: not the {form} form"
            _assert_close(got, rmsnorm_plain(x, w), norm_tol, f"K19 {shape} w {w.dtype}")
    for shape in ((1, 1, 768), (2, 7, 64), (1, 300, 172), (3, 11008), (5,)):
        h1, h3 = randn(*shape), randn(*shape)
        n0 = swiglu.launches
        got = swiglu(h1, h3)
        assert swiglu.launches == n0 + 1 and got.dtype == dtype and got.shape == h1.shape
        _assert_close(got, swiglu_plain(h1, h3), tol, f"K20 {shape}")
    # views one element in: no 16-byte alignment, the scalar paths
    x = randn(2 * 4096 + 1)[1:].view(2, 4096)
    w = 1 + 0.1 * randn(4096)
    n_scalar = rmsnorm.launches_scalar
    _assert_close(rmsnorm(x, w), rmsnorm_plain(x, w), norm_tol, "K19 unaligned")
    assert rmsnorm.launches_scalar == n_scalar + 1
    h = randn(4097)[1:]
    _assert_close(swiglu(h, h), swiglu_plain(h, h), tol, "K20 unaligned")
    with pytest.raises(ValueError):
        swiglu(randn(4), randn(4, dt=torch.float64 if f32 else torch.float32))
    with pytest.raises(ValueError):
        rmsnorm(randn(2, 8).t(), randn(2))  # not contiguous


@pytest.mark.gpu
@pytest.mark.parametrize("layout", [(32, 32, 128), (32, 4, 64), (6, 6, 48)], ids=["7B", "GQA", "stories15M"])
def test_prefill_tensor_core_kernel_matches_plain_on_card(cuda_device, layout):
    """K1's bf16 tensor-core variant against the plain version (float32
    throughout) at the 7B, GQA and stories15M head layouts, T = 1, 16, 201
    and 300 from pos 0, 13 and 1000, and one B = 2 case: one last-bit flip,
    1e-3 + 2^-7 |x|; equal bits on rerun; counted as mma, and fp32 as tf32."""
    H, KVH, hs = layout
    g = torch.Generator(device=cuda_device).manual_seed(15)
    tol = dict(rtol=2**-7, atol=1e-3)

    def randn(*shape, dt=torch.bfloat16):
        return torch.randn(shape, generator=g, device=cuda_device).to(dt)

    k, v = randn(2, KVH, 1536, hs), randn(2, KVH, 1536, hs)
    for T in (1, 16, 201, 300):
        q = randn(1, T, H, hs)
        for pos0 in (0, 13, 1000):
            n0, n_mma = flash_prefill_attention.launches, flash_prefill_attention.launches_mma
            got = flash_prefill_attention(q, k[:1], v[:1], pos0)
            assert flash_prefill_attention.launches == n0 + 1
            assert flash_prefill_attention.launches_mma == n_mma + 1
            want = flash_prefill_attention_plain(q, k[:1], v[:1], pos0)
            torch.cuda.synchronize()
            _assert_close(got, want, tol, f"K1 mma {layout} T={T} pos0={pos0}")
            assert torch.equal(got, flash_prefill_attention(q, k[:1], v[:1], pos0))
    q = randn(2, 77, H, hs)
    _assert_close(flash_prefill_attention(q, k, v, 500), flash_prefill_attention_plain(q, k, v, 500),
                  tol, f"K1 mma {layout} B=2")
    n_tf32 = flash_prefill_attention.launches_tf32
    qf, kf, vf = q.float(), k.float(), v.float()
    _assert_close(flash_prefill_attention(qf, kf, vf, 500), flash_prefill_attention_plain(qf, kf, vf, 500),
                  dict(rtol=2e-5, atol=2e-5), f"K1 tf32 {layout} B=2")
    assert flash_prefill_attention.launches_tf32 == n_tf32 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("layout", [(32, 32, 128), (32, 4, 64), (6, 6, 48), (8, 4, 256), (8, 4, 44)],
                         ids=["7B", "GQA", "stories15M", "hs256", "hs44"])
def test_prefill_tf32_kernel_matches_plain_on_card(cuda_device, layout):
    """K1 in fp32 against the plain version at 2e-5: the TF32 tensor-core
    variant (three passes a product) at every head size that is a multiple
    of 8, the FMA one at head size 44; T = 1, 5, 16, 201 and 300 from pos 0,
    13 and 1000, a 5-token verify window ending at the cache's last row, and
    one B = 2 case; equal bits on rerun; counted by variant; the tickets of
    the key splits zero after."""
    from llama2_tpu_torch.ops.cuda import build

    H, KVH, hs = layout
    S = 1536
    variant = "launches_tf32" if hs % 8 == 0 else "launches_fma"
    g = torch.Generator(device=cuda_device).manual_seed(17)
    tol = dict(rtol=2e-5, atol=2e-5)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    k, v = randn(2, KVH, S, hs), randn(2, KVH, S, hs)
    cases = [(T, pos0) for T in (1, 5, 16, 201, 300) for pos0 in (0, 13, 1000)] + [(5, S - 5)]
    for T, pos0 in cases:
        q = randn(1, T, H, hs)
        n_var = getattr(flash_prefill_attention, variant)
        got = flash_prefill_attention(q, k[:1], v[:1], pos0)
        assert getattr(flash_prefill_attention, variant) == n_var + 1
        want = flash_prefill_attention_plain(q, k[:1], v[:1], pos0)
        torch.cuda.synchronize()
        _assert_close(got, want, tol, f"K1 f32 {layout} T={T} pos0={pos0}")
        assert torch.equal(got, flash_prefill_attention(q, k[:1], v[:1], pos0))
    q = randn(2, 77, H, hs)
    _assert_close(flash_prefill_attention(q, k, v, 500), flash_prefill_attention_plain(q, k, v, 500),
                  tol, f"K1 f32 {layout} B=2")
    # short segments cut their keys over blocks: every ticket is zero after
    assert int(build.workspace(cuda_device, 0)[1].count_nonzero()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fast", "accurate"])
@pytest.mark.parametrize("G", [8, 64])
def test_quant_matmul_wgmma_tile_matches_plain_on_card(cuda_device, G, mode):
    """The M > 8 tile of K5/K6 against the plain version at M = 9, 64, 201
    and 300 on a ragged N (N % 16 != 0 takes 4-byte weight loads, and the
    last column tile is partly past N) and on a 7B-wide one (K split over
    blocks), with and without the rmsnorm prologue and the residual, bf16
    and fp32 activations, in both modes (accurate: x in three bf16 planes,
    or one for bf16 rows with no prologue) at the tolerances of
    ``test_quant_matmul_kernels_match_plain_on_card``; counted on the tile
    of its mode; equal bits on rerun."""
    g = torch.Generator(device=cuda_device).manual_seed(16)

    def randn(*shape, dt):
        return torch.randn(shape, generator=g, device=cuda_device).to(dt)

    def tol(dtype, norm):
        fast_norm = norm and mode == "fast"
        if dtype == torch.bfloat16:
            return dict(rtol=2**-7, atol=2e-3 if fast_norm else 1e-3)
        return dict(rtol=1e-3, atol=1e-3) if fast_norm else dict(rtol=4e-5, atol=4e-5)

    tiles = f"launches_tile_{mode}"
    for K, N in ((512, 1380), (4096, 4096)):
        q = torch.randint(-127, 128, (2, K, N), generator=g, device=cuda_device, dtype=torch.int8)
        scale = 2.7e-4 * (0.7 + 0.6 * torch.rand((2, K // G, N), generator=g, device=cuda_device))
        w = QuantTensor(q, scale, G)
        for M in (9, 64, 201, 300):
            for dtype in (torch.bfloat16, torch.float32):
                x, rms_w, res = randn(M, K, dt=dtype), 1 + 0.1 * randn(K, dt=dtype), randn(M, N, dt=dtype)
                for norm, resid in ((False, False), (True, False), (False, True), (True, True)):
                    kw = dict(mode=mode, rms_w=rms_w if norm else None, residual=res if resid else None)
                    n0, n_tile = quant_matmul_stacked.launches, getattr(quant_matmul_stacked, tiles)
                    got = quant_matmul_stacked(x, w, 1, **kw)
                    assert quant_matmul_stacked.launches == n0 + 1
                    assert getattr(quant_matmul_stacked, tiles) == n_tile + 1
                    want = quant_matmul_stacked_plain(x, w, 1, **kw)
                    torch.cuda.synchronize()
                    _assert_close(got, want, tol(dtype, norm),
                                  f"K6 {mode} tile {K}x{N} G={G} M={M} {dtype} {norm=} {resid=}")
                    assert torch.equal(got, quant_matmul_stacked(x, w, 1, **kw))
        for dtype in (torch.bfloat16, torch.float32):
            x = randn(2, 201, K, dt=dtype)[1:]  # a lead dim and a storage offset
            n_tile = getattr(quant_matmul, tiles)
            _assert_close(quant_matmul(x, w[0], mode=mode), quant_matmul_plain(x, w[0], mode=mode),
                          tol(dtype, False), f"K5 {mode} tile {K}x{N} G={G} {dtype}")
            assert getattr(quant_matmul, tiles) == n_tile + 1


def _offset(t):
    """t's values in a contiguous tensor one element past an aligned start."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "layout,offset",
    [((32, 32, 128), False), ((32, 4, 64), False), ((6, 6, 48), False), ((8, 2, 46), False),
     ((32, 32, 128), True)],
    ids=["7B", "GQA", "stories15M", "hs46", "7B-offset"],
)
def test_split_decode_kernels_match_plain_on_card(cuda_device, dtype, layout, offset):
    """K2 and K4's split form against their plain versions at positions 0, 1,
    splits - 1, 255, 256 and 4095, and per-row at 3 and 8 rows: one launch a
    call, the appends bit-equal, a rerun bit-equal, every ticket zero after.
    Head size 46 (no 16-byte vector divides it) and operands one element off
    16-byte alignment take the one-element-a-lane loop."""
    from llama2_tpu_torch.benchmarks.kernels import rope_tables
    from llama2_tpu_torch.ops.cuda import attention as fa
    from llama2_tpu_torch.ops.cuda import build

    H, KVH, hs = layout
    S, L, layer = 4096, 2, 1
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-3)
    g = torch.Generator(device=cuda_device).manual_seed(17)
    at = _offset if offset else (lambda t: t)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    splits = fa.plan(1, H, KVH, S, hs, dtype, sms)["splits"]
    tickets = build.workspace(cuda_device, 0)[1]
    rows8 = [0, 255, 256, 1000, S - 1, 77, 3000, 2047]
    for pos_list in ([0], [1], [splits - 1], [255], [256], [S - 1], [0, 5, S - 1], rows8):
        B = len(pos_list)
        kc, vc = at(randn(L, B, KVH, S, hs)), at(randn(L, B, KVH, S, hs))
        q, kn, vn, qkv = randn(B, 1, H, hs), at(randn(B, KVH, 1, hs)), at(randn(B, KVH, 1, hs)), at(
            randn(B, H + 2 * KVH, hs))
        pos = torch.tensor(pos_list, dtype=torch.int32, device=cuda_device)
        cos_il, sin_il = rope_tables(pos, hs)
        scalar = offset or hs % (16 // dtype.itemsize) != 0
        calls = (
            (fa.flash_decode_attention_stacked, (kc, vc, kn, vn),
             lambda k, v: fa.flash_decode_attention_stacked(q, k, v, kn, vn, layer, pos),
             lambda k, v: fa.flash_decode_attention_stacked_plain(q, k, v, kn, vn, layer, pos)),
            (fa.flash_decode_attention_fused, (kc, vc, qkv),
             lambda k, v: fa.flash_decode_attention_fused(qkv, k, v, cos_il, sin_il, layer, pos, n_heads=H),
             lambda k, v: fa.flash_decode_attention_fused_plain(qkv, k, v, cos_il, sin_il, layer, pos, H)),
        )
        for wrapper, rows, kernel, plain in calls:
            aligned = all(t.data_ptr() % 16 == 0 for t in rows)
            assert (fa.plan(B, H, KVH, S, hs, dtype, sms, aligned)["vec"] == 1) == scalar
            k1, v1, k2, v2 = (at(t.clone()) for t in (kc, vc, kc, vc))
            kp, vp = kc.clone(), vc.clone()
            n0 = wrapper.launches
            got, again = kernel(k1, v1), kernel(k2, v2)
            assert wrapper.launches == n0 + 2
            want = plain(kp, vp)
            torch.cuda.synchronize()
            what = f"{wrapper.__name__} {layout} offset={offset} {dtype} pos={pos_list}"
            _assert_close(got, want, tol, what)
            assert torch.equal(got, again), what
            assert torch.equal(k1, kp) and torch.equal(v1, vp), what
            assert int(tickets.count_nonzero()) == 0, what


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_block_tensor_core_form_matches_plain_on_card(cuda_device, dtype):
    """K10-K13 on the tensor-core form (``mlp_block.plan``'s "mma"): K10-K12
    at the Llama-2-7B widths and a ragged shape whose last column strip is
    96 wide (group 32), at 3, 4, 5, 8 and 12 rows (a pass of 8, then 4), and
    K13 at 3 and 8 rows over the int8 cache, each against its plain version
    at its unchanged tolerance (2e-3 of the largest |want| for K10-K12, 1e-2
    for K13; bf16 one flip of the last bit more). Every launch counts in
    ``launches_mma``, a rerun gives the same bits and the tickets are zero
    after."""
    from llama2_tpu_torch.ops import ref
    from llama2_tpu_torch.ops.cuda import attention_q8 as aq
    from llama2_tpu_torch.ops.cuda import build
    from llama2_tpu_torch.ops.cuda import layer_block as lb

    g = torch.Generator(device=cuda_device).manual_seed(21)
    L = 4
    rtol = 2e-5 if dtype == torch.float32 else 2**-7

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    def twice(wrapper, *args, **kw):
        n0, m0 = wrapper.launches, wrapper.launches_mma
        a, b = wrapper(*args, **kw), wrapper(*args, **kw)
        assert wrapper.launches == n0 + 2 and wrapper.launches_mma == m0 + 2, wrapper.__name__
        for u, v in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert u is None or torch.equal(u, v), f"{wrapper.__name__}: bits differ on the same inputs"
        return a

    def hold(got, want, frac, what):
        _assert_close(got, want, dict(rtol=rtol, atol=frac * float(want.float().abs().max())), what)

    for D, HD, Dq, G in ((4096, 11008, 12288, 64), (256, 1376, 384, 32)):
        wo, w1, w3 = (_q8_stack(g, cuda_device, L, D, n, G, 2.0) for n in (D, HD, HD))
        w2, wqkv = _q8_stack(g, cuda_device, L, HD, D, G, 2.0), _q8_stack(g, cuda_device, L, D, Dq, G, 2.0)
        rms_ffn, rms_att = 1 + 0.1 * randn(L, D), 1 + 0.1 * randn(L, D)
        for M in (3, 4, 5, 8, 12):
            assert mb.plan(M, D, HD, Dq, (G, G, G, G), 264)["variant"] == "mma"
            x, att = randn(M, D), randn(M, D)
            for layer in (0, L - 1):
                what = f"{D=} {M=} {layer=}"
                got = twice(mb.mlp_block_stacked, x, rms_ffn[layer], w1, w3, w2, layer)
                hold(got, mb.mlp_block_plain(x, rms_ffn[layer], w1, w3, w2, layer), 2e-3, f"K10 {what}")
                got = twice(mb.attn_mlp_block_stacked, att, x, wo, rms_ffn[layer], w1, w3, w2, layer)
                hold(got, mb.attn_mlp_block_plain(att, x, wo, rms_ffn[layer], w1, w3, w2, layer), 2e-3,
                     f"K11 {what}")
                out, qkv = twice(mb.layer_tail_qkv_stacked, att, x, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, layer)
                want = mb.layer_tail_qkv_plain(att, x, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, layer)
                hold(out, want[0], 2e-3, f"K12 out {what}")
                hold(qkv, want[1], 2e-3, f"K12 qkv {what}")
        del wo, w1, w3, w2, wqkv

    H, KVH, hs, S = 32, 32, 128, 1024
    D, HD = H * hs, 11008
    wo, w1, w3 = (_q8_stack(g, cuda_device, L, D, n, 64) for n in (D, HD, HD))
    w2, wqkv = _q8_stack(g, cuda_device, L, HD, D, 64), _q8_stack(g, cuda_device, L, D, (H + 2 * KVH) * hs, 64)
    rms_ffn, rms_att = 1 + 0.1 * randn(L, D), 1 + 0.1 * randn(L, D)
    for pos_list in ([5, 700, 77], [0, 255, 256, 1000, 1023, 77, 600, 31]):
        B = len(pos_list)
        caches = _int8_cache(g, cuda_device, L, B, KVH, S, hs)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=cuda_device)
        cos, sin = ref.rope_angles(pos[:, None], hs)
        cos_il = cos[:, 0].repeat_interleave(2, -1).contiguous()
        sin_il = sin[:, 0].repeat_interleave(2, -1).contiguous()
        qkv3, x = randn(B, H + 2 * KVH, hs), randn(B, D)
        args = (cos_il, sin_il, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, 1, pos)
        runs = [[t.clone() for t in caches] for _ in range(3)]
        n0, m0 = lb.layer_block_stacked.launches, lb.layer_block_stacked.launches_mma
        got = [lb.layer_block_stacked(qkv3, x, *c, *args, n_heads=H) for c in runs[:2]]
        assert lb.layer_block_stacked.launches == n0 + 2 and lb.layer_block_stacked.launches_mma == m0 + 2
        want = lb.layer_block_stacked_plain(qkv3, x, *runs[2], *args, n_heads=H)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(*runs))
        for i in range(2):
            assert torch.equal(got[0][i], got[1][i])
            hold(got[0][i], want[i], 1e-2, f"K13 B={B} {i=}")
    _, tickets = build.workspace(cuda_device, 1)
    assert int(tickets.abs().sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_int8_split_loop_matches_plain_on_card(cuda_device, dtype):
    """K16 and K18 on the split loop at 8 slots whose positions straddle
    pages (0, 255, 256, 1000, 4095 and three more), 256-row pages handed out
    shuffled, the 7B layout (one query row a kv head) and GQA (eight, and
    four in one block), at the plan's split count and at three: against the plain versions at the
    int8-cache tolerance, the pools equal to the plain version's, the same
    bits on a rerun and every ticket zero after; with one 256-key split
    dropped or doubled at pos 4095 the plain output fails the tolerance."""
    from llama2_tpu_torch.ops import ref
    from llama2_tpu_torch.ops.cuda import attention_q8 as aq
    from llama2_tpu_torch.ops.cuda import build
    from llama2_tpu_torch.ops.cuda import paged_attention as tpa

    g = torch.Generator(device=cuda_device).manual_seed(22)
    cpu_g = torch.Generator().manual_seed(22)
    S, L, page = 4096, 2, 256
    pos_list = [0, 255, 256, 1000, S - 1, 511, 2 * page + 77, 9]

    def randn(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=cuda_device).to(dt)

    for H, KVH, hs in ((32, 32, 128), (32, 4, 64), (32, 8, 128)):
        table, wpage, wrow, pos, P = _paged_setup(cpu_g, cuda_device, pos_list, page, 0, S)
        cos, sin = ref.rope_angles(pos[:, None], hs)
        cos_il = cos[:, 0].repeat_interleave(2, -1).contiguous()
        sin_il = sin[:, 0].repeat_interleave(2, -1).contiguous()
        q, qkv = randn(8, H, hs), randn(8, H + 2 * KVH, hs)
        q8 = _int8_cache(g, cuda_device, L, P, KVH, page, hs)
        k8n, ksn = aq.quantize_kv_rows(randn(8, KVH, 1, hs, dt=torch.float32))
        v8n, vsn = aq.quantize_kv_rows(randn(8, KVH, 1, hs, dt=torch.float32))
        coords = (wpage, wrow, L - 1, pos)
        for mode, wrapper, plain, act, post, kw, qt in (
            ("append", tpa.paged_decode_attention_q8_stacked, tpa.paged_decode_attention_q8_stacked_plain, q,
             (table, k8n, ksn, v8n, vsn, *coords), {}, q),
            ("fused", tpa.paged_decode_attention_q8_fused, tpa.paged_decode_attention_q8_fused_plain, qkv,
             (table, cos_il, sin_il, *coords), {"n_heads": H}, aq.rope_quantize_plain(qkv, cos_il, sin_il, H)[0]),
        ):
            want_pools = [t.clone() for t in q8]
            want = plain(act, *want_pools, *post, **kw)[0]
            dense = [tpa.gather_pages(t[L - 1], table, S // page) for t in want_pools]
            terms = (qt[:, None], *dense, pos.long()[:, None])
            tol = _q8kv_tol(dtype, *terms, lambda t: t[:, 0])
            for splits in (None, 3):
                runs = [[t.clone() for t in q8] for _ in range(2)]
                news = dict(q=act) if mode == "append" else dict(qkv=act, rope=(cos_il, sin_il))
                if mode == "append":
                    news["news"] = tuple(t.reshape(8, KVH, -1).contiguous() for t in (k8n, ksn, v8n, vsn))
                n0 = wrapper.launches
                got = [tpa._q8_launch(wrapper, mode, act, c, table, wpage, wrow, L - 1, pos, H, splits=splits, **news)
                       for c in runs]
                assert wrapper.launches == n0 + 2
                torch.cuda.synchronize()
                assert torch.equal(got[0], got[1])
                assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(*runs, want_pools))
                _assert_close(got[0], want, tol, f"{mode} {H=} {KVH=} {splits=}")
                _, tickets = build.workspace(cuda_device, 1)
                assert int(tickets.abs().sum()) == 0
            # a split of the key range dropped, or counted twice, at pos 4095 fails the bound
            b4 = pos_list.index(S - 1)
            for factor in (0.0, 2.0):
                weight = torch.ones(S, device=cuda_device)
                weight[1024:1280] = factor
                bad = _q8kv_terms(*(t[b4:b4 + 1] for t in terms), weight)[0][:, 0].to(dtype)
                with pytest.raises(AssertionError):
                    _assert_close(bad, want[b4:b4 + 1], {k: (v[b4:b4 + 1] if isinstance(v, torch.Tensor) else v)
                                                         for k, v in tol.items()}, "planted")


@pytest.mark.gpu
def test_tick_kernels_raise_on_card_and_do_not_fall_back(cuda_device):
    """On a CUDA tensor the served tick's wrappers launch or raise: K12 with a
    group of 256 (past the kernel's 128), K18 with an odd head size or a
    split count past the kernel's, and K17 with a split count past the
    kernel's raise ValueError and count no launch; K17's C entry refuses a
    plan it cannot take (a chunk that is not its instance's, 33 splits).
    So do K3 and K14 on the read-only split form, which also refuse more
    than one split over more (b, query head) pairs than there are tickets."""
    from llama2_tpu_torch.ops.cuda import build
    from llama2_tpu_torch.ops.cuda import paged_attention as tpa

    g = torch.Generator(device=cuda_device).manual_seed(23)
    L, D, HD, Dq = 2, 512, 768, 1024
    wo, w1, w3 = (_q8_stack(g, cuda_device, L, D, n, 256) for n in (D, HD, HD))
    w2, wqkv = _q8_stack(g, cuda_device, L, HD, D, 256), _q8_stack(g, cuda_device, L, D, Dq, 256)
    rms = torch.ones((L, D), device=cuda_device)
    x = torch.randn((8, D), generator=g, device=cuda_device)
    n0, m0 = mb.layer_tail_qkv_stacked.launches, mb.layer_tail_qkv_stacked.launches_mma
    with pytest.raises(ValueError):
        mb.layer_tail_qkv_stacked(x, x, wo, rms, w1, w3, w2, rms, wqkv, 0)
    assert (mb.layer_tail_qkv_stacked.launches, mb.layer_tail_qkv_stacked.launches_mma) == (n0, m0)

    z = torch.zeros
    B, H, KVH, page = 2, 4, 4, 16
    i32 = dict(dtype=torch.int32, device=cuda_device)
    table, ci = z((B, 2), **i32), z((B,), **i32)
    n0 = tpa.paged_decode_attention_q8_fused.launches
    for hs in (33, 32):
        pools = [z((1, 3, KVH, page, hs), dtype=torch.int8, device=cuda_device), z((1, 3, KVH, page), device=cuda_device)] * 2
        qkv = z((B, H + 2 * KVH, hs), device=cuda_device)
        rope = (z((B, hs), device=cuda_device), z((B, hs), device=cuda_device))
        with pytest.raises(ValueError):
            if hs % 2:
                tpa.paged_decode_attention_q8_fused(qkv, *pools, table, *rope, ci, ci, 0, ci, n_heads=H)
            else:
                tpa._q8_launch(tpa.paged_decode_attention_q8_fused, "fused", qkv, pools, table, ci, ci, 0, ci, H,
                               qkv=qkv, rope=rope, splits=33)
    assert tpa.paged_decode_attention_q8_fused.launches == n0

    # K17 on the split form: a split count past the kernel's is refused by the
    # plan, and a chunk that is not the instance's by the C entry
    hs = 32
    pools = [z((1, 3, KVH, page, hs), device=cuda_device) for _ in range(2)]
    qkv = z((B, H + 2 * KVH, hs), device=cuda_device)
    rope = (z((B, hs), device=cuda_device), z((B, hs), device=cuda_device))
    n0 = tpa.paged_decode_attention_fused.launches
    with pytest.raises(ValueError, match="splits"):
        tpa._fp_launch(tpa.paged_decode_attention_fused, qkv, *pools, *rope, table, ci, ci, 0, ci, H, splits=33)
    assert tpa.paged_decode_attention_fused.launches == n0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = tpa.fp_plan(qkv, *pools, *rope, table, H, sms, True)
    ws, tickets = build.workspace(cuda_device, p["ws_floats"])
    out = z((B, H, hs), device=cuda_device)
    for chunk, splits in ((p["chunk"] + 1, p["splits"]), (p["chunk"], 33)):
        err = tpa._entry("paged_decode_attention_fused")(
            qkv.data_ptr(), pools[0].data_ptr(), pools[1].data_ptr(), rope[0].data_ptr(), rope[1].data_ptr(),
            table.data_ptr(), ci.data_ptr(), ci.data_ptr(), ci.data_ptr(), out.data_ptr(), ws.data_ptr(),
            tickets.data_ptr(), ws.numel(), tickets.numel(), 0, 0, B, H, KVH, 3, page, 2, hs, splits, p["vec"],
            chunk, 1.0, torch.cuda.current_stream().cuda_stream)
        assert err != 0, (chunk, splits)

    # K3 and K14 on the read-only split form: 33 splits are refused by the
    # plan, with no launch counted, and by the C entries; more than one split
    # over more pairs than there are tickets is refused too
    from llama2_tpu_torch.ops.cuda import attention as fa

    q, pos = z((B, H, hs), device=cuda_device), z((B,), **i32)
    k3, kp = z((B, KVH, 2 * page, hs), device=cuda_device), pools[0][0]
    n3, n14 = fa.flash_decode_attention.launches, tpa.paged_decode_attention.launches
    with pytest.raises(ValueError, match="splits"):
        fa.launch_read(q, k3, k3, pos, 1.0, splits=33)
    with pytest.raises(ValueError, match="splits"):
        tpa._read_launch(q, kp, kp, table, pos, 1.0, splits=33)
    Bw = build.MAX_TICKETS // H + 1
    qw, posw = z((Bw, H, hs), device=cuda_device), z((Bw,), **i32)
    with pytest.raises(ValueError, match="tickets"):
        fa.launch_read(qw, z((Bw, KVH, page, hs), device=cuda_device), z((Bw, KVH, page, hs), device=cuda_device),
                       posw, 1.0, splits=2)
    with pytest.raises(ValueError, match="tickets"):
        tpa._read_launch(qw, kp, kp, z((Bw, 2), **i32), posw, 1.0, splits=2)
    assert (fa.flash_decode_attention.launches, tpa.paged_decode_attention.launches) == (n3, n14)
    p3 = fa.plan(B, H, KVH, 2 * page, hs, torch.float32, sms)
    for chunk, splits in ((p3["chunk"] + 1, p3["splits"]), (p3["chunk"], 33)):
        err = fa._entry_read()(
            q.data_ptr(), k3.data_ptr(), k3.data_ptr(), pos.data_ptr(), out.data_ptr(), ws.data_ptr(),
            tickets.data_ptr(), ws.numel(), tickets.numel(), 0, B, H, KVH, 2 * page, hs, splits, p3["vec"], chunk,
            1.0, torch.cuda.current_stream().cuda_stream)
        assert err != 0, ("K3", chunk, splits)
        err = tpa._entry_read()(
            q.data_ptr(), kp.data_ptr(), kp.data_ptr(), table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            ws.data_ptr(), tickets.data_ptr(), ws.numel(), tickets.numel(), 0, B, H, KVH, 3, page, 2, hs, splits,
            p3["vec"], chunk, 1.0, torch.cuda.current_stream().cuda_stream)
        assert err != 0, ("K14", chunk, splits)
    torch.cuda.synchronize()


def _tickets_zero(device):
    from llama2_tpu_torch.ops.cuda import build

    return int(build.workspace(device, 0)[1].count_nonzero()) == 0


def _planted_fail(terms, want, tol, b, shape):
    """Row b's plain output with one 256-key split dropped, or doubled, in
    the merge at pos 4095 fails the tolerance ``tol``."""
    S = terms[1].shape[2]
    for factor in (0.0, 2.0):
        weight = torch.ones(S, device=want.device)
        weight[1024:1280] = factor
        bad = shape(_q8kv_terms(*(t[b:b + 1] for t in terms), weight)[0]).to(want.dtype)
        with pytest.raises(AssertionError):
            _assert_close(bad, want[b:b + 1], {k: (v[b:b + 1] if isinstance(v, torch.Tensor) else v)
                                               for k, v in tol.items()}, "planted")


ROWS8 = [0, 1, 255, 256, 4095, 511, 1000, 9]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", [(32, 32, 128), (32, 4, 64), (32, 8, 128)], ids=["7B", "GQA", "GQA4"])
def test_dense_int8_split_loop_matches_plain_on_card(cuda_device, dtype, layout):
    """K7 (windows of 1, 4 and 12 rows: at the 7B layout one row a block,
    four in one block, and two groups of eight), K8 and K9 (1 and 8 rows)
    on the split decode loop over dense planes, rows at pos 0, 1, 255, 256 and 4095 (a window's rows at T - 1 or
    later): against the plain versions at the int8-cache tolerance, the
    appends equal to the plain version's, the same bits on a rerun, every
    ticket zero after; one split dropped or doubled at pos 4095 fails the
    bound."""
    from llama2_tpu_torch.benchmarks.kernels import rope_tables
    from llama2_tpu_torch.ops.cuda import attention_q8 as aq

    H, KVH, hs = layout
    S, L, layer = 4096, 2, 1
    g = torch.Generator(device=cuda_device).manual_seed(24)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    for B in (1, 8):
        rows = [S - 1] if B == 1 else ROWS8
        b4 = rows.index(S - 1)
        cache1 = _int8_cache(g, cuda_device, B, KVH, S, hs)
        for T in (1, 4, 12):
            pos = torch.tensor([max(p, T - 1) for p in rows], dtype=torch.int32, device=cuda_device)
            q = randn(B, T, H, hs)
            n0 = aq.flash_decode_attention_q8.launches
            got, again = (aq.flash_decode_attention_q8(q, *cache1, pos) for _ in range(2))
            assert aq.flash_decode_attention_q8.launches == n0 + 2
            want = aq.flash_decode_attention_q8_plain(q, *cache1, pos)
            torch.cuda.synchronize()
            horizon = pos.long()[:, None] - (T - 1) + torch.arange(T, device=cuda_device)[None, :]
            terms = (q, *cache1, horizon)
            tol = _q8kv_tol(dtype, *terms)
            what = f"K7 {layout} {B=} {T=}"
            _assert_close(got, want, tol, what)
            assert torch.equal(got, again) and _tickets_zero(cuda_device), what
            if T == 1:
                _planted_fail(terms, want, tol, b4, lambda t: t)
        caches = _int8_cache(g, cuda_device, L, B, KVH, S, hs)
        pos = torch.tensor(rows, dtype=torch.int32, device=cuda_device)
        q, qkv = randn(B, H, hs), randn(B, H + 2 * KVH, hs)
        kn, ksn = aq.quantize_kv_rows(randn(B, KVH, 1, hs).float())
        vn, vsn = aq.quantize_kv_rows(randn(B, KVH, 1, hs).float())
        cos_il, sin_il = rope_tables(pos, hs)
        q_rot = aq.rope_quantize_plain(qkv, cos_il, sin_il, H)[0]
        for wrapper, kern, plain, qt in (
            (aq.flash_decode_attention_q8_stacked,
             lambda c: aq.flash_decode_attention_q8_stacked(q, *c, kn, ksn, vn, vsn, layer, pos),
             lambda c: aq.flash_decode_attention_q8_stacked_plain(q, *c, kn, ksn, vn, vsn, layer, pos), q),
            (aq.flash_decode_attention_q8_fused,
             lambda c: aq.flash_decode_attention_q8_fused(qkv, *c, cos_il, sin_il, layer, pos, n_heads=H),
             lambda c: aq.flash_decode_attention_q8_fused_plain(qkv, *c, cos_il, sin_il, layer, pos, H), q_rot),
        ):
            runs = [[t.clone() for t in caches] for _ in range(3)]
            n0 = wrapper.launches
            got = [kern(c) for c in runs[:2]]
            assert wrapper.launches == n0 + 2
            want = plain(runs[2])
            torch.cuda.synchronize()
            what = f"{wrapper.__name__} {layout} {B=}"
            terms = (qt[:, None], *[t[layer] for t in runs[2]], pos.long()[:, None])
            tol = _q8kv_tol(dtype, *terms, lambda t: t[:, 0])
            _assert_close(got[0], want, tol, what)
            assert torch.equal(got[0], got[1]) and _tickets_zero(cuda_device), what
            assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(*runs)), what
            _planted_fail(terms, want, tol, b4, lambda t: t[:, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KVH", [32, 8], ids=["7B", "GQA"])
def test_layer_block_split_attention_matches_plain_on_card(cuda_device, dtype, KVH):
    """K13 with its attention phase on the split loop, at 1, 2, 3 and 8 rows
    (the FMA form with two warp loads a pass at 1 and 2 rows, the
    tensor-core form with four at 3 and 8), rows at pos 0 (only this step's
    row), 1, 255, 256 and 4095, at the Llama-2-7B widths, and with 8 kv
    heads (four query heads each, one group a query head); out and qkv'
    within 1e-2 of max|want| of the plain version (bf16 one flip of the last
    bit more), the appends equal to the plain version's, the same bits on a
    rerun, every ticket zero after. Its attention phase alone (wo the
    identity, w2 and x zero, so that out = bf16(att)) at the int8-cache
    tolerance, which one split dropped or doubled at pos 4095 fails."""
    from llama2_tpu_torch.benchmarks.kernels import rope_tables
    from llama2_tpu_torch.ops.cuda import attention_q8 as aq
    from llama2_tpu_torch.ops.cuda import layer_block as lb

    g = torch.Generator(device=cuda_device).manual_seed(25)
    H, hs, L, S, G = 32, 128, 2, 4096, 64
    D, HD = H * hs, 11008
    wo, w1, w3 = (_q8_stack(g, cuda_device, L, D, n, G) for n in (D, HD, HD))
    w2, wqkv = _q8_stack(g, cuda_device, L, HD, D, G), _q8_stack(g, cuda_device, L, D, (H + 2 * KVH) * hs, G)
    rms_ffn = (1 + 0.1 * torch.randn((L, D), generator=g, device=cuda_device)).to(dtype)
    rms_att = (1 + 0.1 * torch.randn((L, D), generator=g, device=cuda_device)).to(dtype)
    eye = (64 * torch.eye(D, device=cuda_device)).to(torch.int8)
    wo_id = QuantTensor(eye.expand(L, D, D).contiguous(), torch.full((L, D // G, D), 2.0**-6, device=cuda_device), G)
    w2_0 = QuantTensor(torch.zeros_like(w2.q), w2.scale, G)
    del eye
    rtol = 0.0 if dtype == torch.float32 else 2**-7  # bf16: one flip of the last bit
    cases = ([0], [1], [255], [256], [S - 1], [0, S - 1], [1, 256], [255, 0, S - 1], ROWS8)
    for pos_list in cases if KVH == H else ([S - 1], [0, 255, S - 1]):
        M = len(pos_list)
        caches = _int8_cache(g, cuda_device, L, M, KVH, S, hs)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=cuda_device)
        cos_il, sin_il = rope_tables(pos, hs)
        qkv3 = torch.randn((M, H + 2 * KVH, hs), generator=g, device=cuda_device).to(dtype)
        x = torch.randn((M, D), generator=g, device=cuda_device).to(dtype)
        for with_qkv in (True, False):
            layer = 0 if with_qkv else L - 1
            args = (cos_il, sin_il, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, layer, pos)
            runs = [[t.clone() for t in caches] for _ in range(3)]
            n0 = lb.layer_block_stacked.launches
            got = [lb.layer_block_stacked(qkv3, x, *c, *args, n_heads=H, with_qkv=with_qkv) for c in runs[:2]]
            assert lb.layer_block_stacked.launches == n0 + 2
            want = lb.layer_block_stacked_plain(qkv3, x, *runs[2], *args, n_heads=H, with_qkv=with_qkv)
            torch.cuda.synchronize()
            what = f"K13 {dtype} {pos_list=} {with_qkv=}"
            assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(*runs)), what
            assert _tickets_zero(cuda_device), what
            for i in range(2 if with_qkv else 1):
                assert torch.equal(got[0][i], got[1][i]), what
                scale = float(want[i].float().abs().max())
                _assert_close(got[0][i], want[i], dict(rtol=rtol, atol=1e-2 * scale), what)
        # the attention phase alone
        args = (cos_il, sin_il, wo_id, rms_ffn, w1, w3, w2_0, rms_att, wqkv, L - 1, pos)
        zero = torch.zeros((M, D), dtype=dtype, device=cuda_device)
        runs = [[t.clone() for t in caches] for _ in range(2)]
        got = lb.layer_block_stacked(qkv3, zero, *runs[0], *args, n_heads=H, with_qkv=False)[0]
        want = lb.layer_block_stacked_plain(qkv3, zero, *runs[1], *args, n_heads=H, with_qkv=False)[0]
        torch.cuda.synchronize()
        q_rot = aq.rope_quantize_plain(qkv3, cos_il, sin_il, H)[0]
        terms = (q_rot[:, None], *[t[L - 1] for t in runs[1]], pos.long()[:, None])
        shape = lambda t: t.reshape(M, D)  # noqa: E731
        tol = _q8kv_tol(dtype, *terms, shape)
        tol["rtol"] = 2**-7  # att is rounded to bf16 in both dtypes
        _assert_close(got, want, tol, f"K13 attention phase {dtype} {pos_list=}")
        if S - 1 in pos_list:
            _planted_fail(terms, want, tol, pos_list.index(S - 1), lambda t: t.reshape(1, D).to(torch.bfloat16))
        del caches, runs


def _planted_fp_fail(qf, k, v, want, tol, what):
    """The fp attention of one slot with keys 1024..1279 (one split of 256
    keys) dropped, or counted twice, fails ``tol`` against ``want``: qf
    (H, hs) float32, scaled; k, v (KVH, n, hs) the slot's rows; want (H, hs)."""
    H, KVH = qf.shape[0], k.shape[0]
    s = torch.einsum("kgd,ktd->kgt", qf.reshape(KVH, H // KVH, -1), k.float())
    for factor in (0.0, 2.0):
        w = torch.exp(s - s.amax(-1, keepdim=True))
        w[..., 1024:1280] *= factor
        bad = (torch.einsum("kgt,ktd->kgd", w, v.float()) / w.sum(-1, keepdim=True)).reshape(H, -1)
        with pytest.raises(AssertionError):
            _assert_close(bad.to(want.dtype), want, tol, f"planted {what}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", [(32, 32, 128), (32, 4, 64), (6, 6, 48)], ids=["7B", "GQA", "stories15M"])
def test_paged_fp_split_loop_matches_plain_on_card(cuda_device, dtype, layout):
    """K15 and K17 on K2/K4's split form through the page table: 8 slots
    whose positions straddle pages (0, 255, 256, 1000, 4095, a third page's
    row; two inactive slots on the scratch page 0), 256-row pages handed out
    shuffled, at the plan's split count and at 3 and 8 (split edges inside
    pages): the active slots' outputs within the fp tolerance of the plain
    versions, the inactive ones finite, the pools equal to the plain
    version's, the same bits on a rerun and every ticket zero after; with
    one 256-key split dropped or doubled at pos 4095 the plain output fails
    the tolerance."""
    from llama2_tpu_torch.benchmarks.kernels import rope_tables
    from llama2_tpu_torch.ops.cuda import attention as fa
    from llama2_tpu_torch.ops.cuda import paged_attention as tpa

    H, KVH, hs = layout
    g = torch.Generator(device=cuda_device).manual_seed(26)
    cpu_g = torch.Generator().manual_seed(26)
    S, L, page, act = 4096, 2, 256, 6
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-3)
    pos_list = [0, 255, 256, 1000, S - 1, 2 * page + 77, 5, 9]
    table, wpage, wrow, pos, P = _paged_setup(cpu_g, cuda_device, pos_list, page, 2, S)
    cos_il, sin_il = rope_tables(pos, hs)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    q, qkv = randn(8, H, hs), randn(8, H + 2 * KVH, hs)
    kn, vn = randn(8, KVH, 1, hs), randn(8, KVH, 1, hs)
    pools = [randn(L, P, KVH, page, hs), randn(L, P, KVH, page, hs)]
    coords = (table, wpage, wrow, L - 1, pos)
    q_rot = fa.rope_rows_plain(qkv, cos_il, sin_il, H, dtype)[0]
    b4 = pos_list.index(S - 1)
    for which, a, news, plain, kw, qf in (
        (tpa.paged_decode_attention_stacked, q, (kn, vn),
         lambda c: tpa.paged_decode_attention_stacked_plain(q, *c, table, kn, vn, *coords[1:])[0], {}, q.float()),
        (tpa.paged_decode_attention_fused, qkv, (cos_il, sin_il),
         lambda c: tpa.paged_decode_attention_fused_plain(qkv, *c, table, cos_il, sin_il, *coords[1:], H)[0],
         {"n_heads": H}, q_rot),
    ):
        want_pools = [t.clone() for t in pools]
        want = plain(want_pools)
        for splits in (None, 3, 8):
            runs = [[t.clone() for t in pools] for _ in range(2)]
            n0 = which.launches
            got = [tpa._fp_launch(which, a, *c, *news, *coords, H, splits=splits) for c in runs]
            assert which.launches == n0 + 2
            torch.cuda.synchronize()
            what = f"{which.__name__} {layout} {dtype} {splits=}"
            assert torch.equal(got[0][:act], got[1][:act]), what
            assert bool(torch.isfinite(got[0].float()).all()), what
            assert all(torch.equal(x, y) and torch.equal(x, w) for x, y, w in zip(*runs, want_pools)), what
            assert _tickets_zero(cuda_device), what
            _assert_close(got[0][:act], want[:act], tol, what)
        k4, v4 = (tpa.gather_pages(t[L - 1], table[b4:b4 + 1], S // page)[0] for t in want_pools)
        _planted_fp_fail(qf[b4] * hs**-0.5, k4, v4, want[b4], tol, which.__name__)



@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", [(32, 32, 128), (32, 4, 64)], ids=["7B", "GQA"])
def test_read_only_split_block_matches_plain_on_card(cuda_device, dtype, layout):
    """K3 and K14 on the read-only split block (``split_block_read``): 8 rows
    whose positions straddle pages (0, 255, 256, 1000, 4095, a third page's
    row, 5, 9), K3 over one layer's dense caches and K14 over the same rows
    in shuffled 256-row pages whose table names a NaN page past each row's
    last, at a given scale, at the plan's split count and at 3 and 8 (split
    edges inside pages): within the fp tolerance of the plain version, the
    same bits on a rerun, every ticket zero after, the caches and pools
    untouched; with one 256-key split dropped or doubled at pos 4095 the
    plain output fails the tolerance."""
    from llama2_tpu_torch.ops.cuda import attention as fa
    from llama2_tpu_torch.ops.cuda import paged_attention as tpa

    H, KVH, hs = layout
    g = torch.Generator(device=cuda_device).manual_seed(27)
    cpu_g = torch.Generator().manual_seed(27)
    S, page, scale = 4096, 256, 0.8 / hs**0.5
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-3)
    pos_list = [0, 255, 256, 1000, S - 1, 2 * page + 77, 5, 9]
    table, _, _, pos, P = _paged_setup(cpu_g, cuda_device, pos_list, page, 0, S)
    used = torch.arange(table.shape[1], device=cuda_device)[None] <= (pos // page)[:, None]
    nan_table = torch.where(used, table, torch.full_like(table, P))

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    q = randn(8, H, hs)
    k, v = randn(8, KVH, S, hs), randn(8, KVH, S, hs)
    kp, vp = randn(P + 1, KVH, page, hs), randn(P + 1, KVH, page, hs)
    kp[P], vp[P] = float("nan"), float("nan")
    k0, v0, kp0, vp0 = (t.clone() for t in (k, v, kp, vp))
    b4 = pos_list.index(S - 1)
    for which, run, plain, rows in (
        (fa.flash_decode_attention, lambda n: fa.launch_read(q, k, v, pos, scale, splits=n),
         fa.flash_decode_attention_plain(q, k, v, pos, scale=scale), (k[b4], v[b4])),
        (tpa.paged_decode_attention, lambda n: tpa._read_launch(q, kp, vp, nan_table, pos, scale, splits=n),
         tpa.paged_decode_attention_plain(q, kp, vp, table, pos, scale=scale),
         tuple(tpa.gather_pages(t, table[b4:b4 + 1], S // page)[0] for t in (kp, vp))),
    ):
        for splits in (None, 3, 8):
            n0 = which.launches
            got = [run(splits) for _ in range(2)]
            assert which.launches == n0 + 2
            torch.cuda.synchronize()
            what = f"{which.__name__} {layout} {dtype} {splits=}"
            assert torch.equal(got[0], got[1]), what
            assert _tickets_zero(cuda_device), what
            _assert_close(got[0], plain, tol, what)
        _planted_fp_fail(q[b4].float() * scale, *rows, plain[b4], tol, which.__name__)
    assert all(torch.equal(a.nan_to_num(), b.nan_to_num()) for a, b in zip((k, v, kp, vp), (k0, v0, kp0, vp0)))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_classifier_at_the_perplexity_chunk_matches_plain_on_card(cuda_device, mode):
    """K5 at M = 256 x K = 4096 x V = 32000, the perplexity chunk's
    classifier over every position: on the M > 8 tile of its mode, against
    the plain version at the tolerances of
    ``test_quant_matmul_wgmma_tile_matches_plain_on_card``, bf16 and fp32
    activations; the same bits on a rerun."""
    g = torch.Generator(device=cuda_device).manual_seed(160)
    K, V, G, M = 4096, 32000, 64, 256
    q = torch.randint(-127, 128, (K, V), generator=g, device=cuda_device, dtype=torch.int8)
    w = QuantTensor(q, 2.7e-4 * (0.7 + 0.6 * torch.rand((K // G, V), generator=g, device=cuda_device)), G)
    tiles = f"launches_tile_{mode}"
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((M, K), generator=g, device=cuda_device).to(dtype)
        n0, n_tile = quant_matmul.launches, getattr(quant_matmul, tiles)
        got = quant_matmul(x, w, mode=mode)
        assert quant_matmul.launches == n0 + 1 and getattr(quant_matmul, tiles) == n_tile + 1
        tol = dict(rtol=2**-7, atol=1e-3) if dtype == torch.bfloat16 else dict(rtol=4e-5, atol=4e-5)
        _assert_close(got, quant_matmul_plain(x, w, mode=mode), tol, f"K5 {mode} M={M} {dtype}")
        assert torch.equal(got, quant_matmul(x, w, mode=mode))


@pytest.mark.gpu
@pytest.mark.parametrize("backend,kv_quant", [("cuda", True), ("cuda", False), ("cuda-accurate", False)])
def test_precompile_leaves_the_first_wave_no_build_and_no_plan_miss(cuda_device, backend, kv_quant, monkeypatch):
    """``BatchEngine.precompile`` for prompts of 16 and 40 tokens, both
    samplers and the speculative window: a first wave of such requests
    (greedy and sampled, so plain ticks and windows both run) then starts
    no ``nvcc`` and misses no launch plan, and its streams equal an
    engine's without precompile."""
    from llama2_tpu_torch.ops.cuda import build
    from llama2_tpu_torch.runtime.batch_engine import PLAN_CACHES, BatchEngine

    config = ModelConfig(dim=256, hidden_dim=704, n_layers=3, n_heads=2, n_kv_heads=2, vocab_size=512,
                         seq_len=256)
    dtype = torch.bfloat16 if backend == "cuda" else torch.float32
    params = random_q8_params(config, 16, cuda_device, dtype, group_size=64)
    g = torch.Generator().manual_seed(16)
    prompts = [torch.randint(3, 512, (n,), generator=g).tolist() for n in (16, 40, 16, 40)]
    # the sampled requests end first: the greedy ones then run speculative windows
    gens = [GenerationConfig(temperature=0.0, steps=80), GenerationConfig(temperature=0.8, steps=50, seed=2),
            GenerationConfig(temperature=0.8, steps=30, seed=3), GenerationConfig(temperature=0.0, steps=80)]

    def wave(precompile: bool):
        eng = BatchEngine(config, params, batch_size=4, dtype=dtype, backend=backend, device=cuda_device,
                          kv_quant=kv_quant, spec_window=4)
        if precompile:
            assert eng.precompile(prompt_lens=(16, 40), stochastic=(False, True), spec=True) >= 0
            misses = {k: f.cache_info().misses for k, f in PLAN_CACHES.items()}
            monkeypatch.setattr(build, "_start_build", lambda *a: pytest.fail(f"the first wave built {a[0]}"))
        queues = [eng.submit(p, gen) for p, gen in zip(prompts, gens)]
        eng.run_until_idle()
        out = [q.get(timeout=300).tokens for q in queues]
        if precompile:
            assert {k: f.cache_info().misses for k, f in PLAN_CACHES.items()} == misses
            assert eng.metrics["spec_windows"] > 0
            monkeypatch.undo()
        return out

    assert wave(True) == wave(False)


@pytest.mark.gpu
def test_load_tokenizer_builds_the_cpp_tokenizer_on_card(cuda_device):
    """Where the kernels run, the entry points' tokenizer is the C++ one,
    with the Python tokenizer's ids."""
    import os

    from llama2_tpu_torch.tokenizer.fast import FastTokenizer, load_tokenizer
    from llama2_tpu_torch.tokenizer.tokenizer import Tokenizer

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "tokenizer.bin")
    fast, py = load_tokenizer(path, 32000), Tokenizer.from_file(path, 32000)
    assert isinstance(fast, FastTokenizer)
    text = "Once upon a time, there was a little girl named Lily. Zebras & émus aren't common—café.\n"
    assert fast.encode(text) == py.encode(text) and fast.decode(py.encode(text)) == py.decode(py.encode(text))


@pytest.mark.gpu
def test_quantize_on_card_gives_the_numpy_bytes(cuda_device):
    """``quant/q8.py::quantize`` of a tensor on the card: the numpy path's
    int8 values and scales bit for bit (the CLI and the server quantize on
    load there), with zero groups and exact halves among the values."""
    import numpy as np

    from llama2_tpu_torch.quant.q8 import quantize

    rng = np.random.default_rng(17)
    for shape, G in (((3, 4096, 1000), 64), ((640, 4099), 32), ((2, 128, 48), 16)):
        w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        w[..., :G, 0] = 0.0
        w[..., G : 2 * G, 1] = np.arange(G, dtype=np.float32) - G / 2  # ties at .5 after scaling
        want, got = quantize(w, G), quantize(torch.from_numpy(w).to(cuda_device), G)
        assert got.q.device.type == "cuda"
        assert torch.equal(got.q.cpu(), want.q) and torch.equal(got.scale.cpu(), want.scale)


# ---- tensor parallelism: the kernels at a rank's shard shapes (slice 17) ----


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mesh_shard_shapes_match_plain_on_card(cuda_device, dtype):
    """The kernels of a sharded decode layer at the 7B model's tp = 2 and 4
    shard shapes, each against its plain version: K10 with ``residual=False``
    (D 4096, HD/tp 5504 and 2752; 1 and 8 rows, counted in
    ``launches_no_residual``); K6 without the residual at the row-parallel
    in-features (wo's 2048 and 1024, w2's 5504 and 2752; M = 1, 8, 201); K5
    on the vocab slices (N = 16000 and 8000); K4 and K9 at 16 and 8 local
    heads. Tolerances as the full-width tests of each kernel."""
    from llama2_tpu_torch.ops import ref
    from llama2_tpu_torch.ops.cuda import attention_q8 as aq

    g = torch.Generator(device=cuda_device).manual_seed(17)
    D, L, G = 4096, 2, 64

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    for tp in (2, 4):
        HD = 11008 // tp
        w1, w3, w2 = _q8_stack(g, cuda_device, L, D, HD, G), _q8_stack(g, cuda_device, L, D, HD, G), \
            _q8_stack(g, cuda_device, L, HD, D, G)
        rms = 1 + 0.1 * randn(L, D)
        for M in (1, 8):
            x = randn(M, D)
            n0, r0 = mb.mlp_block_stacked.launches, mb.mlp_block_stacked.launches_no_residual
            got = mb.mlp_block_stacked(x, rms[1], w1, w3, w2, 1, residual=False)
            assert (mb.mlp_block_stacked.launches, mb.mlp_block_stacked.launches_no_residual) == (n0 + 1, r0 + 1)
            want = mb.mlp_block_plain(x, rms[1], w1, w3, w2, 1, residual=False)
            tol = dict(rtol=2e-5 if dtype == torch.float32 else 2**-7, atol=2e-3 * float(want.float().abs().max()))
            _assert_close(got, want, tol, f"K10 {tp=} {M=}")
        del w1, w3, w2
        for K in (D // tp, HD):
            w = _q8_stack(g, cuda_device, L, K, D, G)
            for M in (1, 8, 201):
                x = randn(M, K)
                got = quant_matmul_stacked(x, w, 1)
                want = quant_matmul_stacked_plain(x, w, 1)
                tol = dict(rtol=2**-7, atol=1e-3) if dtype == torch.bfloat16 else dict(rtol=4e-5, atol=4e-5)
                _assert_close(got, want, tol, f"K6 {tp=} {K=} {M=}")
            del w
        w = _q8_stack(g, cuda_device, 1, D, 32000 // tp, G)[0]
        for M in (1, 8):
            x = randn(M, D)
            n0 = quant_matmul.launches
            got = quant_matmul(x, w)
            assert quant_matmul.launches == n0 + 1
            tol = dict(rtol=2**-7, atol=1e-3) if dtype == torch.bfloat16 else dict(rtol=4e-5, atol=4e-5)
            _assert_close(got, quant_matmul_plain(x, w), tol, f"K5 N={32000 // tp} {M=}")
        H = 32 // tp
        S, hs, B = 4096, 128, 8
        pos = torch.tensor([0, 5, 127, 128, 1000, 2047, 4000, S - 1], dtype=torch.int32, device=cuda_device)
        cos, sin = ref.rope_angles(pos[:, None], hs)
        cos_il = cos[:, 0].repeat_interleave(2, -1).contiguous()
        sin_il = sin[:, 0].repeat_interleave(2, -1).contiguous()
        qkv = randn(B, 3 * H, hs)
        kc, vc = randn(L, B, H, S, hs), randn(L, B, H, S, hs)
        kp, vp = kc.clone(), vc.clone()
        got = flash_decode_attention_fused(qkv, kc, vc, cos_il, sin_il, 1, pos, n_heads=H)
        want = flash_decode_attention_fused_plain(qkv, kp, vp, cos_il, sin_il, 1, pos, H)
        tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-3)
        _assert_close(got, want, tol, f"K4 {H=}")
        assert torch.equal(kc, kp) and torch.equal(vc, vp)
        del kc, vc, kp, vp
        caches = _int8_cache(g, cuda_device, L, B, H, S, hs)
        runs = [[t.clone() for t in caches] for _ in range(2)]
        got = aq.flash_decode_attention_q8_fused(qkv, *runs[0], cos_il, sin_il, 1, pos, n_heads=H)
        want = aq.flash_decode_attention_q8_fused_plain(qkv, *runs[1], cos_il, sin_il, 1, pos, H)
        q_rot = aq.rope_quantize_plain(qkv, cos_il, sin_il, H)[0]
        tol = _q8kv_tol(dtype, q_rot[:, None], *[t[1] for t in runs[1]], pos.long()[:, None], lambda t: t[:, 0])
        _assert_close(got, want, tol, f"K9 {H=}")
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        del caches, runs


def _gloo_rank(mesh):
    """A CUDA tensor's all-reduce and all-gather over gloo, on cuda:0."""
    import torch.distributed as dist

    from llama2_tpu_torch.parallel.tp import add_reduced, gather

    x = torch.full((4, 8), float(mesh.rank + 1), device=mesh.device, dtype=torch.bfloat16)
    reduced = add_reduced(torch.zeros_like(x), x, mesh.model_group)
    gathered = gather(torch.arange(3, device=mesh.device) + 10 * mesh.rank, mesh.model_group, 0)
    return dist.get_backend(), str(mesh.device), reduced.float().cpu().tolist(), gathered.cpu().tolist()


@pytest.mark.gpu
def test_gloo_collectives_of_cuda_tensors_on_one_card(cuda_device):
    """Two ranks on the one card: the backend rule picks gloo, and gloo
    all-reduces and all-gathers tensors on cuda:0 (the mesh path's row
    reduces and logits / token gathers)."""
    from llama2_tpu_torch.parallel import distributed

    if torch.cuda.device_count() != 1:
        pytest.skip("the one-card rule")
    out = distributed.launch(_gloo_rank, 1, 2, "cuda", deadline=120.0, libraries=())
    for backend, device, reduced, gathered in out:
        assert (backend, device) == ("gloo", "cuda:0")
        assert reduced == [[3.0] * 8] * 4
        assert gathered == [0, 1, 2, 10, 11, 12]


def _ring_rank(mesh):
    """One ring hop of a CUDA tensor over the model group (staged through
    the host on gloo, by the backend rule), and ``ring_linear_local`` of the
    rank's shards of a dense and a Q8 weight, on cuda:0."""
    import torch.distributed as dist

    from llama2_tpu_torch.parallel import collective_matmul as cm
    from llama2_tpu_torch.quant.q8 import QuantTensor, dequantize, quantize

    group, t = mesh.model_group, mesh.coord[1]
    sent = torch.randn(3, 5, generator=torch.Generator().manual_seed(mesh.rank)).to(mesh.device, torch.bfloat16)
    staged = cm._staged(group, sent.device)
    got, _ = cm._hop(cm._Ring(group), sent, staged)
    g = torch.Generator().manual_seed(7)
    x, w = torch.randn(4, 256, generator=g), torch.randn(256, 64, generator=g)
    wq = quantize(torch.randn(2, 256, 64, generator=g), 64)
    rows = slice(t * 128, (t + 1) * 128)
    shard = QuantTensor(wq.q[:, rows].contiguous(), wq.scale[:, 2 * t : 2 * (t + 1)].contiguous(), 64).to(mesh.device)
    dense = cm.ring_linear_local(x[:, rows].to(mesh.device), w[rows].to(mesh.device), group)
    q8 = cm.ring_linear_local(x[:, rows].to(mesh.device), shard, group, layer=1)
    # numpy, not tensors: a tensor crosses the result queue as a handle to the rank's memory
    return {"backend": dist.get_backend(group), "staged": staged, "device": str(got.device),
            "sent": sent.float().cpu().numpy(), "got": got.float().cpu().numpy(), "dense": dense.cpu().numpy(),
            "want_dense": (x.double() @ w.double()).numpy(), "q8": q8.cpu().numpy(),
            "want_q8": (x.double() @ dequantize(wq[1]).double()).numpy()}


@pytest.mark.gpu
def test_ring_hop_and_ring_linear_of_cuda_tensors_on_one_card(cuda_device):
    """Two ranks on the one card: gloo by the backend rule, each hop staged
    through the host; a bf16 chunk arrives on cuda:0 bit for bit from the
    previous rank; ``ring_linear_local`` of the ranks' shards (fp32, and a
    layer-stacked Q8 shard) equals the dense product within 1e-5 of the
    largest output."""
    from llama2_tpu_torch.parallel import distributed

    if torch.cuda.device_count() != 1:
        pytest.skip("the one-card rule")
    out = distributed.launch(_ring_rank, 1, 2, "cuda", deadline=120.0, libraries=())
    for r, res in enumerate(out):
        assert (res["backend"], res["staged"], res["device"]) == ("gloo", True, "cuda:0")
        assert np.array_equal(res["got"], out[(r - 1) % 2]["sent"])  # bf16 widened exactly to float32
        for key in ("dense", "q8"):
            want = res[f"want_{key}"]
            assert np.abs(res[key] - want).max() <= 1e-5 * np.abs(want).max(), key


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_int8_kernels_at_a_ranks_shard_on_card(cuda_device, dtype):
    """K16 and K18 at a rank's shard of the 7B layout at tp = 2 (16 heads
    over a 16-head int8 pool), through a table of the shard's local page
    ids handed out shuffled, 256- and 128-row pages, 8 slots (two inactive
    on the scratch page): against their plain versions at the int8-cache
    tolerance, the pools equal to the plain version's, one launch a call."""
    from llama2_tpu_torch.ops import ref
    from llama2_tpu_torch.ops.cuda import attention_q8 as aq
    from llama2_tpu_torch.ops.cuda import paged_attention as tpa

    g = torch.Generator(device=cuda_device).manual_seed(31)
    cpu_g = torch.Generator().manual_seed(31)
    S, L, act = 4096, 2, 6
    H, KVH, hs = 16, 16, 128

    def randn(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=cuda_device).to(dt)

    for page in (256, 128):
        pos_list = [0, page - 1, page, 1000, S - 1, 2 * page + 77, 5, 9]
        table, wpage, wrow, pos, P = _paged_setup(cpu_g, cuda_device, pos_list, page, 2, S)
        cos, sin = ref.rope_angles(pos[:, None], hs)
        cos_il = cos[:, 0].repeat_interleave(2, -1).contiguous()
        sin_il = sin[:, 0].repeat_interleave(2, -1).contiguous()
        q, qkv = randn(8, H, hs), randn(8, H + 2 * KVH, hs)
        q8 = _int8_cache(g, cuda_device, L, P, KVH, page, hs)
        k8n, ksn = aq.quantize_kv_rows(randn(8, KVH, 1, hs, dt=torch.float32))
        v8n, vsn = aq.quantize_kv_rows(randn(8, KVH, 1, hs, dt=torch.float32))
        coords = (wpage, wrow, L - 1, pos)
        for wrapper, plain, pre, post, kw, qt in (
            (tpa.paged_decode_attention_q8_stacked, tpa.paged_decode_attention_q8_stacked_plain, q,
             (table, k8n, ksn, v8n, vsn, *coords), {}, q),
            (tpa.paged_decode_attention_q8_fused, tpa.paged_decode_attention_q8_fused_plain, qkv,
             (table, cos_il, sin_il, *coords), {"n_heads": H}, aq.rope_quantize_plain(qkv, cos_il, sin_il, H)[0]),
        ):
            got_pools, want_pools = [t.clone() for t in q8], [t.clone() for t in q8]
            n0 = wrapper.launches
            got = wrapper(pre, *got_pools, *post, **kw)[0]
            assert wrapper.launches == n0 + 1
            want = plain(pre, *want_pools, *post, **kw)[0]
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got_pools, want_pools))
            dense = [tpa.gather_pages(t[L - 1], table, S // page)[:act] for t in want_pools]
            tol = _q8kv_tol(dtype, qt[:act, None], *dense, pos.long()[:act, None], lambda t: t[:, 0])
            _assert_close(got[:act], want[:act], tol, f"{wrapper.__name__} {page=}")
            assert torch.isfinite(got.float()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", [(32, 32, 128), (32, 8, 128)], ids=["7B", "GQA"])
def test_seq_decode_attention_on_card_matches_plain_attention(cuda_device, layout):
    """``ring_decode.seq_decode_attention`` at sp = 1 (the local statistics
    and the merge, no collective) on cuda:0, fp32, against
    ``ops/ref.py::attention`` over the same cache: T = 1 and a 4-row window,
    at positions 0, 2047 and 4095, within 2e-5."""
    from llama2_tpu_torch.ops import ref
    from llama2_tpu_torch.parallel.ring_decode import seq_decode_attention

    H, KVH, hs = layout
    S, B = 4096, 2
    g = torch.Generator(device=cuda_device).manual_seed(41)
    k = torch.randn(B, KVH, S, hs, generator=g, device=cuda_device)
    v = torch.randn(B, KVH, S, hs, generator=g, device=cuda_device)
    for T in (1, 4):
        for pos in (T - 1, 2047, 4095):
            q = torch.randn(B, T, H, hs, generator=g, device=cuda_device)
            got = seq_decode_attention(q, k, v, pos, None, S, 1.0 / hs**0.5)
            want = ref.attention(q, k, v, pos - (T - 1))
            assert got.device.type == "cuda" and torch.isfinite(got).all()
            assert (got - want).abs().max().item() <= 2e-5, (T, pos)


def _stage_hop_rank(mesh):
    """One stage hop of a CUDA activation (a bf16 and an fp32 one) over the
    stage group, on cuda:0 (staged through the host on gloo)."""
    import torch.distributed as dist

    from llama2_tpu_torch.parallel import collective_matmul as cm
    from llama2_tpu_torch.parallel.mesh import STAGE_AXIS

    hop = cm.Hop(mesh.group(STAGE_AXIS), mesh.device)
    out = {"backend": dist.get_backend(mesh.group(STAGE_AXIS)), "staged": hop.staged, "hops": cm.hops}
    for dt in (torch.bfloat16, torch.float32):
        sent = torch.randn(4, 256, 4096, generator=torch.Generator().manual_seed(mesh.rank)).to(mesh.device, dt)
        got = hop(sent)
        # numpy, not tensors: a tensor crosses the result queue as a handle to the rank's memory
        out[dt] = (str(got.device), got.dtype == dt, sent.float().cpu().numpy(), got.float().cpu().numpy())
    out["hops"] = cm.hops - out["hops"]
    return out


@pytest.mark.gpu
def test_stage_hop_of_a_cuda_activation_between_two_ranks_on_one_card(cuda_device):
    """Two stages on the one card: gloo by the backend rule, the hop staged
    through the host; each stage's (4, 256, 4096) activation arrives on
    cuda:0 at the next stage bit for bit, in its dtype."""
    from llama2_tpu_torch.parallel import distributed

    if torch.cuda.device_count() != 1:
        pytest.skip("the one-card rule")
    out = distributed.launch(_stage_hop_rank, 2, 1, "cuda", axis="stage", deadline=120.0, libraries=())
    for r, res in enumerate(out):
        assert (res["backend"], res["staged"], res["hops"]) == ("gloo", True, 2)
        for dt in (torch.bfloat16, torch.float32):
            device, same_dtype, _, got = res[dt]
            assert device == "cuda:0" and same_dtype
            assert np.array_equal(got, out[(r - 1) % 2][dt][2])
