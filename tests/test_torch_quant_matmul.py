"""The torch port's dequant-matmul kernels K5/K6 against the JAX Pallas
kernels.

On the CPU the wrappers run their plain PyTorch versions, which are held
against ``quant_matmul`` and ``quant_matmul_stacked`` of
``llama2_tpu/ops/pallas/quant_matmul.py`` in interpret mode on the same
seeded numpy inputs. Tolerances:

* accurate mode: rtol = atol = 1e-5, the JAX kernel tests' bar against the
  dequant-dot oracle (only the float32 summation order differs);
* fast mode against the JAX kernel's FAST mode: both round x to bf16 and sum
  exact products in float32 within a group, so only summation order differs:
  rtol = atol = 1e-5 (largest difference seen over these cases: 2.4e-6). With
  the rmsnorm prologue the two normed rows differ in their last float32 bit,
  which now and then flips the bf16 rounding of one x (one product moves by
  2^-9 |x w|, about 2e-4 here): rtol = atol = 5e-4 (largest seen: 1.5e-4);
* fast mode against the float32 dequant oracle: ``3e-2 * max(1, sqrt(K/512))``,
  the JAX tests' own bar for the bf16 rounding of x.

The CUDA kernels themselves are checked against the plain versions on the card
by ``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama2_tpu.ops import xla as jops
from llama2_tpu.ops.pallas.quant_matmul import quant_matmul as jax_k5
from llama2_tpu.ops.pallas.quant_matmul import quant_matmul_stacked as jax_k6
from llama2_tpu.quant import q8 as jq
from llama2_tpu_torch.ops.cuda import quant_matmul as qm
from llama2_tpu_torch.ops.linear import linear
from llama2_tpu_torch.quant import q8 as tq

TOL = {"accurate": dict(rtol=1e-5, atol=1e-5), "fast": dict(rtol=1e-5, atol=1e-5)}
TOL_FAST_NORM = dict(rtol=5e-4, atol=5e-4)

# (K, N, G): a decode matvec shape, a K with no dividing K-tile on the TPU
# (ragged there; here the loop runs to K/G groups exactly), a long K
SHAPES = [(256, 384, 64), (280, 128, 8), (2176, 128, 64)]


def oracle_tol(K: int) -> float:
    return 3e-2 * max(1.0, (K / 512.0) ** 0.5)


def both(w: np.ndarray, G: int):
    """The same weights quantized for each package."""
    return jq.quantize(w, G), tq.quantize(w, G)


@pytest.mark.parametrize("mode", ["accurate", "fast"])
@pytest.mark.parametrize("M", [1, 4, 40])
@pytest.mark.parametrize("K,N,G", SHAPES)
def test_quant_matmul_plain_vs_jax_kernel(mode, M, K, N, G):
    rng = np.random.default_rng(M * 1000 + K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    jt, tt = both(rng.standard_normal((K, N)).astype(np.float32) * 0.1, G)
    want = np.asarray(jax_k5(jnp.asarray(x), jt, interpret=True, mode=mode))
    before = qm.quant_matmul.launches
    got = qm.quant_matmul(torch.from_numpy(x), tt, mode=mode)
    assert qm.quant_matmul.launches == before  # CPU tensors: plain, no launch
    assert got.shape == (M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL[mode])
    oracle = x @ np.asarray(jq.dequantize(jt))
    tol = 1e-5 if mode == "accurate" else oracle_tol(K)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=tol, atol=max(tol, 1e-4 if K > 2000 else 0))


@pytest.mark.parametrize("mode", ["accurate", "fast"])
@pytest.mark.parametrize("norm,resid", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("M", [1, 4, 40])
@pytest.mark.parametrize("K,N,G", SHAPES)
def test_quant_matmul_stacked_plain_vs_jax_kernel(mode, norm, resid, M, K, N, G):
    L, layer = 3, 2
    rng = np.random.default_rng(M * 100 + K + 2 * norm + resid)
    x = rng.standard_normal((M, K)).astype(np.float32)
    jt, tt = both(rng.standard_normal((L, K, N)).astype(np.float32) * 0.05, G)
    rms_w = rng.standard_normal(K).astype(np.float32) if norm else None
    res = rng.standard_normal((M, N)).astype(np.float32) if resid else None
    want = np.asarray(
        jax_k6(
            jnp.asarray(x), jt, layer, interpret=True, mode=mode,
            rms_w=None if rms_w is None else jnp.asarray(rms_w), eps=1e-5,
            residual=None if res is None else jnp.asarray(res),
        )
    )
    before = qm.quant_matmul_stacked.launches
    got = qm.quant_matmul_stacked(
        torch.from_numpy(x), tt, layer, mode=mode,
        rms_w=None if rms_w is None else torch.from_numpy(rms_w), eps=1e-5,
        residual=None if res is None else torch.from_numpy(res),
    )
    assert qm.quant_matmul_stacked.launches == before
    assert got.shape == (M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), want, **(TOL_FAST_NORM if norm and mode == "fast" else TOL[mode])
    )

    xn = np.asarray(jops.rmsnorm(jnp.asarray(x), jnp.asarray(rms_w), 1e-5)) if norm else x
    oracle = xn @ np.asarray(jq.dequantize(jt))[layer] + (res if resid else 0.0)
    tol = 2e-5 if mode == "accurate" else oracle_tol(K)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["accurate", "fast"])
def test_quant_matmul_lead_dims_and_layers(mode):
    """Leading dims flatten into rows; every layer of a stack is its own
    weight (a wrong layer offset would show)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    res = rng.standard_normal((2, 3, 256)).astype(np.float32)
    jt, tt = both(rng.standard_normal((4, 128, 256)).astype(np.float32), 64)
    for layer in range(4):
        want = np.asarray(jax_k6(jnp.asarray(x), jt, layer, interpret=True, mode=mode,
                                 residual=jnp.asarray(res)))
        got = qm.quant_matmul_stacked(torch.from_numpy(x), tt, layer, mode=mode,
                                      residual=torch.from_numpy(res))
        assert got.shape == (2, 3, 256)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    jt2 = jq.QuantTensor(q=jt.q[1], scale=jt.scale[1], group_size=64)
    got = qm.quant_matmul(torch.from_numpy(x), tt[1], mode=mode)
    want = np.asarray(jax_k5(jnp.asarray(x), jt2, interpret=True, mode=mode))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_quant_matmul_bf16_activations():
    """bf16 x: float32 inside, one rounding of the output to bf16."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32)).bfloat16()
    tt = tq.quantize(rng.standard_normal((2, 256, 64)).astype(np.float32) * 0.1, 64)
    rms_w = torch.from_numpy(1 + 0.1 * rng.standard_normal(256).astype(np.float32)).bfloat16()
    res = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32)).bfloat16()
    for mode in ("accurate", "fast"):
        got = qm.quant_matmul_stacked(x, tt, 1, mode=mode, rms_w=rms_w, residual=res)
        assert got.dtype == torch.bfloat16
        want = qm.quant_matmul_stacked(x.float(), tt, 1, mode=mode, rms_w=rms_w.float(),
                                       residual=res.float())
        torch.testing.assert_close(got.float(), want, rtol=2**-7, atol=1e-3)


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda-accurate"])
def test_linear_quantized_branches_match_jax(backend):
    """``linear`` with a 2-D and a stacked QuantTensor against the JAX
    ``linear`` on the matching backend."""
    from llama2_tpu.ops.linear import linear as jax_linear

    jax_backend = {"torch": "xla", "cuda": "pallas", "cuda-accurate": "pallas-accurate"}[backend]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    jt, tt = both(rng.standard_normal((3, 128, 96)).astype(np.float32) * 0.1, 32)
    want = np.asarray(jax_linear(jnp.asarray(x), jt, backend=jax_backend, layer=1))
    got = linear(torch.from_numpy(x), tt, backend, layer=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    jt2 = jq.QuantTensor(q=jt.q[2], scale=jt.scale[2], group_size=32)
    want = np.asarray(jax_linear(jnp.asarray(x), jt2, backend=jax_backend))
    got = linear(torch.from_numpy(x), tt[2], backend)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    w = rng.standard_normal((128, 96)).astype(np.float32)
    np.testing.assert_allclose(
        linear(torch.from_numpy(x), torch.from_numpy(w), backend).numpy(), x @ w, rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize(
    "bad", ["mode", "rank2", "rank3", "layer", "ragged_group", "scale_shape", "x_width", "meta_device"]
)
def test_quant_matmul_wrappers_reject(bad):
    x = torch.zeros(2, 64)
    t3 = tq.quantize(np.ones((2, 64, 8), np.float32), 32)
    t2 = t3[0]
    with pytest.raises(ValueError):
        if bad == "mode":
            qm.quant_matmul(x, t2, mode="exact")
        elif bad == "rank2":
            qm.quant_matmul(x, t3)
        elif bad == "rank3":
            qm.quant_matmul_stacked(x, t2, 0)
        elif bad == "layer":
            qm.quant_matmul_stacked(x, t3, 2)
        elif bad == "ragged_group":
            qm.quant_matmul(x, tq.QuantTensor(t2.q, t2.scale, 48))
        elif bad == "scale_shape":
            qm.quant_matmul(x, tq.QuantTensor(t2.q, t2.scale[:1], 32))
        elif bad == "x_width":
            qm.quant_matmul(torch.zeros(2, 32), t2)
        else:  # no silent plain version for a device the wrapper does not serve
            qm.quant_matmul(x.to("meta"), tq.QuantTensor(t2.q.to("meta"), t2.scale.to("meta"), 32))


def test_kernel_plan_covers_the_7b_shapes():
    """The launch plan at Llama-2-7B widths: decode rows split K over whole
    rounds of a block's 8 warps so that about two to four blocks an SM (132
    SMs) are in flight."""
    for K, N in ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000)):
        p = qm.plan(1, K, N, 64)
        assert p["mt"] == 1 and p["strips"] == -(-N // 128)
        assert 250 <= p["strips"] * p["ksplit"] <= 4 * 132 and p["ksplit"] <= K // 64 // 8
        assert qm.plan(201, K, N, 64) == {"mt": 0, "ksplit": 1, "kc": 32, "strips": 0}
        assert qm.plan(8, K, N, 64)["mt"] == 8 and qm.plan(3, K, N, 64)["mt"] == 4
    assert qm.plan(1, 64, 64, 16)["ksplit"] == 1  # a tiny model: no split
    assert qm.plan(40, 172, 64, 4)["kc"] == 4 and qm.plan(40, 96, 64, 48)["kc"] == 24
    with pytest.raises(ValueError):
        qm.plan(1, 64, 30, 16)
    with pytest.raises(ValueError):
        qm.plan(1, 512, 64, 256)
