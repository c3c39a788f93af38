"""The torch port's rmsnorm K19 and swiglu K20 against the JAX Pallas kernels.

On the CPU ``rmsnorm`` and ``swiglu`` run their plain versions, held against
``llama2_tpu/ops/pallas/rmsnorm.py::rmsnorm`` and ``swiglu.py::swiglu`` in
interpret mode at the shapes of ``tests/test_pallas_kernels.py``'s rmsnorm
and swiglu tests (288, 64 and 172 wide; 768, 64 and 172), float32 at that
file's tolerance (rtol 1e-5, atol 1e-6). bf16 rows: the output keeps x's (or
h1's) dtype, as the Pallas kernels store it, also under a float32 weight,
held to two last-bit steps of bf16 (both sides round twice, and float32 sums
taken in another order can tip the first rounding). The CUDA kernels are held
against the plain versions on the card by ``tests/test_torch_kernels_gpu.py``
and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama2_tpu.ops.pallas.rmsnorm import rmsnorm as jax_k19
from llama2_tpu.ops.pallas.swiglu import swiglu as jax_k20
from llama2_tpu_torch.ops.cuda.rmsnorm import rmsnorm
from llama2_tpu_torch.ops.cuda.swiglu import swiglu

TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2**-6, atol=1e-3)


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16, as float32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("shape", [(1, 1, 288), (2, 7, 64), (1, 300, 172)])
def test_rmsnorm_plain_vs_jax_kernel(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    want = np.asarray(jax_k19(jnp.asarray(x), jnp.asarray(w), interpret=True))
    before = rmsnorm.launches
    got = rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    assert rmsnorm.launches == before  # CPU tensors: plain, no launch
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", [(1, 1, 768), (2, 7, 64), (1, 300, 172)])
def test_swiglu_plain_vs_jax_kernel(shape):
    rng = np.random.default_rng(0)
    h1 = rng.standard_normal(shape).astype(np.float32)
    h3 = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_k20(jnp.asarray(h1), jnp.asarray(h3), interpret=True))
    before = swiglu.launches
    got = swiglu(torch.from_numpy(h1), torch.from_numpy(h3))
    assert swiglu.launches == before
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bf16_rows_keep_their_dtype_vs_jax_kernels():
    """bf16 rows: both kernels store bf16 (the Pallas rmsnorm takes a weight
    of x's dtype); under a float32 weight the port's still does, where
    ``ref.rmsnorm`` promotes to float32."""
    rng = np.random.default_rng(1)
    x = _bf16(rng.standard_normal((5, 96)).astype(np.float32))
    w = _bf16((1 + 0.1 * rng.standard_normal(96)).astype(np.float32))
    want = np.asarray(jax_k19(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), interpret=True))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = rmsnorm(xb, torch.from_numpy(w).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), **BF16_TOL)
    got_f32w = rmsnorm(xb, torch.from_numpy(w))
    assert got_f32w.dtype == torch.bfloat16
    np.testing.assert_allclose(got_f32w.float().numpy(), want.astype(np.float32), **BF16_TOL)
    h1, h3 = (_bf16(rng.standard_normal((5, 96)).astype(np.float32)) for _ in range(2))
    want = np.asarray(jax_k20(jnp.asarray(h1, jnp.bfloat16), jnp.asarray(h3, jnp.bfloat16), interpret=True))
    got = swiglu(torch.from_numpy(h1).to(torch.bfloat16), torch.from_numpy(h3).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), **BF16_TOL)


def test_wrappers_refuse_mismatched_operands():
    with pytest.raises(ValueError):
        rmsnorm(torch.zeros(2, 8), torch.zeros(7))
    with pytest.raises(ValueError):
        swiglu(torch.zeros(2, 8), torch.zeros(2, 7))


@pytest.mark.parametrize("R,D,dtype,aligned,want", [
    (256, 4096, torch.float32, True, ("regs", 128, 1)),  # 1024 vectors: 128 threads x 8
    (1024, 8192, torch.float32, True, ("regs", 256, 1)),  # the largest tier, full
    (1, 8196, torch.float32, True, ("loop", 0, 1)),  # one vector past every tier
    (256, 1024, torch.float32, True, ("regs", 32, 1)),  # a warp a row, full
    (256, 1028, torch.float32, True, ("regs", 64, 1)),  # one vector past it
    (256, 4096, torch.bfloat16, True, ("regs", 64, 1)),  # 8 elements a vector
    (3, 16392, torch.bfloat16, True, ("loop", 0, 1)),
    (4096, 288, torch.float32, True, ("regs", 32, 8)),  # short rows, eight a block
    (300, 172, torch.float32, True, ("regs", 32, 2)),  # as many a block as keep a block an SM
    (3, 4098, torch.float32, True, ("scalar", 0, 1)),  # ragged
    (2, 4096, torch.float32, False, ("scalar", 0, 1)),  # an unaligned view
])
def test_rmsnorm_plan(R, D, dtype, aligned, want):
    """K19's form by row length, dtype and alignment: the register form at
    the fewest threads a row (32-256, 8 vectors a thread) and as many rows a
    block as leave a block for each of 132 SMs; the loop form past the
    tiers; the scalar form for ragged or unaligned rows."""
    from llama2_tpu_torch.ops.cuda.rmsnorm import plan

    p = plan(R, D, dtype, aligned, 132)
    assert (p["form"], p["tpr"], p["rows"]) == want
    assert p["grid"] == -(-R // p["rows"])
    if p["form"] == "regs":
        assert p["tpr"] * p["rows"] <= 256 and D // (16 // dtype.itemsize) <= 8 * p["tpr"]
