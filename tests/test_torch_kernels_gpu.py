"""Card-only tests of the torch port: the CUDA kernels against their plain
versions, and generation on the card against generation on the CPU.

They carry the ``gpu`` marker and skip without a CUDA device. This file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from llama2_tpu_torch.config import GenerationConfig, ModelConfig
from llama2_tpu_torch.io.convert import random_params
from llama2_tpu_torch.ops.cuda.attention import (
    flash_decode_attention_stacked,
    flash_decode_attention_stacked_plain,
)
from llama2_tpu_torch.ops.cuda.prefill_attention import (
    flash_prefill_attention,
    flash_prefill_attention_plain,
)
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
