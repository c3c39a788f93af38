"""Card-only tests of the torch port: the CUDA kernels against their plain
versions, and generation on the card against generation on the CPU.

They carry the ``gpu`` marker and skip without a CUDA device. This file
imports no JAX, so it also runs where JAX is absent:

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
    assert bool((err <= bound).all()), f"{what}: max abs err {float(err.max()):.3e} past {tol}"


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
    fast = Generator(config, params, backend="cuda", device=cuda_device).generate(prompt, gen)
    assert fast.tokens[: len(prompt)] == prompt and len(fast.tokens) > len(prompt)
    assert flash_decode_attention_fused.launches > n4
    assert quant_matmul.launches > n5 and quant_matmul_stacked.launches > n6
