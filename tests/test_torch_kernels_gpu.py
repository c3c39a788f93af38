"""Card-only tests of the torch port: the CUDA kernels against their plain
versions, and generation on the card against generation on the CPU.

They carry the ``gpu`` marker and skip without a CUDA device; one test
without it checks on the CPU that the int8-cache attention tolerance fails
planted faults. This file imports no JAX, so it also runs where JAX is
absent:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

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
    Llama-2-7B head layout; fp32 to 2e-5, bf16 to one last-bit flip."""
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-3)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    H, hs, S = 32, 128, 1024

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    k, v, q = randn(1, H, S, hs), randn(1, H, S, hs), randn(1, 77, H, hs)
    n1 = flash_prefill_attention.launches
    got = flash_prefill_attention(q, k, v, 100)
    assert flash_prefill_attention.launches == n1 + 1
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
    epilogue. fp32 outputs: 4e-5 (the float32 rounding of sums over K = 4096
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
                got = quant_matmul_stacked(x, w, layer, **kw)
                assert quant_matmul_stacked.launches == n0 + 1
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
    assert counts == (aq.flash_decode_attention_q8.launches, aq.flash_decode_attention_q8_stacked.launches,
                      lb.layer_block_stacked.launches)


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
