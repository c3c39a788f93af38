"""The torch port's single-layer decode attention K3 against the JAX package.

On the CPU ``flash_decode_attention`` runs its plain version, which is held
against ``llama2_tpu/ops/pallas/attention.py::flash_decode_attention`` in
interpret mode on the six shapes of
``tests/test_pallas_kernels.py::test_flash_decode_vs_oracle`` (an int
position), its per-row positions case and its lane-padded case (a head dim
zero-padded to 128 with the real scale passed), float32, at that file's
tolerance (rtol/atol 1e-5). The CUDA kernel is held against the plain version
on the card by ``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama2_tpu.ops.pallas.attention import flash_decode_attention as jax_k3
from llama2_tpu_torch.ops.cuda.attention import flash_decode_attention

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(rng, B, H, KVH, hs, S):
    return (rng.standard_normal((B, 1, H, hs)).astype(np.float32),
            rng.standard_normal((B, KVH, S, hs)).astype(np.float32),
            rng.standard_normal((B, KVH, S, hs)).astype(np.float32))


@pytest.mark.parametrize(
    "B,H,KVH,hs,S,pos",
    [
        (1, 6, 6, 48, 256, 0),
        (1, 6, 6, 48, 256, 100),
        (1, 6, 6, 48, 256, 255),
        (2, 8, 2, 64, 128, 127),
        (1, 4, 1, 32, 64, 17),
        (1, 32, 4, 128, 512, 300),
    ],
)
def test_flash_decode_plain_vs_jax_kernel(B, H, KVH, hs, S, pos):
    q, k, v = _inputs(np.random.default_rng(B * 100 + pos), B, H, KVH, hs, S)
    want = np.asarray(jax_k3(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, interpret=True))
    before = flash_decode_attention.launches
    got = flash_decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos)
    assert flash_decode_attention.launches == before  # CPU tensors: plain, no launch
    assert got.shape == (B, 1, H, hs) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the (B, H, hs) form, with the position as a one-element tensor
    got3 = flash_decode_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(k), torch.from_numpy(v),
                                  torch.tensor([pos], dtype=torch.int32))
    np.testing.assert_allclose(got3.numpy(), want[:, 0], **TOL)


def test_flash_decode_per_row_positions_vs_jax_kernel():
    q, k, v = _inputs(np.random.default_rng(0), 3, 4, 2, 64, 128)
    pos = np.asarray([5, 77, 127], np.int32)
    want = np.asarray(jax_k3(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                             interpret=True))
    got = flash_decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_decode_lane_padded_cache_vs_jax_kernel():
    """A head dim zero-padded to 128 with the real scale: the padded lanes
    change nothing, as in the JAX package."""
    B, H, KVH, hs, S = 1, 6, 6, 48, 64
    q, k, v = _inputs(np.random.default_rng(1), B, H, KVH, hs, S)
    pad = ((0, 0), (0, 0), (0, 0), (0, 128 - hs))
    qp, kp, vp = np.pad(q, pad), np.pad(k, pad), np.pad(v, pad)
    scale = 1.0 / hs**0.5
    want = np.asarray(jax_k3(jnp.asarray(qp), jnp.asarray(kp), jnp.asarray(vp), 40, scale=scale,
                             interpret=True))
    got = flash_decode_attention(torch.from_numpy(qp), torch.from_numpy(kp), torch.from_numpy(vp), 40,
                                 scale=scale)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    unpadded = flash_decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 40)
    np.testing.assert_allclose(got.numpy()[..., :hs], unpadded.numpy(), **TOL)


def test_flash_decode_refuses_bad_operands():
    q, k, v = (torch.zeros(1, 1, 4, 32), torch.zeros(1, 2, 16, 32), torch.zeros(1, 2, 16, 32))
    with pytest.raises(ValueError):
        flash_decode_attention(q, k, v, 16)  # past the cache
    with pytest.raises(ValueError):
        flash_decode_attention(torch.zeros(1, 2, 4, 32), k, v, 0)  # T = 2
    with pytest.raises(ValueError):
        flash_decode_attention(torch.zeros(1, 1, 3, 32), k, v, 0)  # H % KVH
