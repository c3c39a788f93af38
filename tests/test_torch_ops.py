"""The torch port's plain ops and samplers against the JAX package.

``llama2_tpu_torch/ops/ref.py`` against ``llama2_tpu/ops/xla.py`` and
``llama2_tpu_torch/ops/sampling.py`` against ``llama2_tpu/ops/sampling.py``
on the same seeded numpy inputs. The samplers get the same uniform draw: the
test draws it from the JAX key exactly as the JAX sampler does and hands it
to the port. The JAX side runs under ``jax.jit``: one compile per shape
instead of one per operation. Tolerances: fp32 2e-5 relative and absolute (the JAX kernel
tests' bound; only summation order differs); bf16 one unit in the last
place (2^-7 relative), since each side rounds f32 results to bf16 once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama2_tpu.ops import sampling as js
from llama2_tpu.ops import xla as jx
from llama2_tpu_torch.ops import ref
from llama2_tpu_torch.ops import sampling as ts

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2**-7, atol=1e-6)
# the JAX references, compiled whole
J = {
    name: jax.jit(getattr(jx, name))
    for name in ("rmsnorm", "apply_rope", "attention", "swiglu", "softmax")
}
J_MULTINOMIAL, J_TOP_P = jax.jit(js.sample_multinomial), jax.jit(js.sample_top_p)
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL), "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def both(a: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a torch tensor of ``dtype`` (both
    round the same float32 values to bf16 the same way)."""
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.ascontiguousarray(a)).to(td)


def assert_same(j, t, tol):
    np.testing.assert_allclose(
        np.asarray(j.astype(jnp.float32)), t.float().numpy(), **tol
    )


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 1, 288), (2, 7, 64), (1, 300, 172)])
def test_rmsnorm(shape, dtype):
    rng = np.random.default_rng(0)
    xj, xt = both(rng.standard_normal(shape).astype(np.float32), dtype)
    wj, wt = both((1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32), dtype)
    assert_same(J["rmsnorm"](xj, wj), ref.rmsnorm(xt, wt), DTYPES[dtype][2])


@pytest.mark.parametrize("hs", [16, 48, 128])
def test_rope_angles(hs):
    pos = np.array([[0, 1, 7, 300], [13, 100, 1000, 4095]], np.int32)
    cj, sj = jx.rope_angles(jnp.asarray(pos), hs)
    ct, st = ref.rope_angles(torch.from_numpy(pos), hs)
    assert ct.shape == (2, 4, hs // 2) and ct.dtype == torch.float32
    # cos/sin of angles up to ~4e3 rad: the two libraries' f32 range
    # reductions may differ by an ulp of the angle
    np.testing.assert_allclose(np.asarray(cj), ct.numpy(), atol=2e-6)
    np.testing.assert_allclose(np.asarray(sj), st.numpy(), atol=2e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope(per_row, dtype):
    rng = np.random.default_rng(1)
    B, T, H, hs = 2, 5, 3, 16
    xj, xt = both(rng.standard_normal((B, T, H, hs)).astype(np.float32), dtype)
    pos = np.arange(T, dtype=np.int32) + 11
    if per_row:
        pos = np.stack([pos, pos + 40])
    cj, sj = jx.rope_angles(jnp.asarray(pos), hs)
    ct, st = ref.rope_angles(torch.from_numpy(pos), hs)
    assert_same(J["apply_rope"](xj, cj, sj), ref.apply_rope(xt, ct, st), DTYPES[dtype][2])


@pytest.mark.parametrize(
    "B,T,H,KVH,hs,S,pos",
    [
        (1, 1, 6, 6, 48, 64, 40),  # decode, MHA
        (1, 8, 4, 2, 16, 64, 0),  # prefill from 0, GQA
        (2, 5, 4, 1, 32, 64, 10),  # MQA, batch
        (3, 1, 4, 2, 16, 32, [5, 17, 31]),  # per-row positions
    ],
)
def test_attention(B, T, H, KVH, hs, S, pos):
    rng = np.random.default_rng(T * 10 + B)
    q = rng.standard_normal((B, T, H, hs)).astype(np.float32)
    k = rng.standard_normal((B, KVH, S, hs)).astype(np.float32)
    v = rng.standard_normal((B, KVH, S, hs)).astype(np.float32)
    want = J["attention"](jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    got = ref.attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(pos) if isinstance(pos, list) else pos,
    )
    assert_same(want, got, F32_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_swiglu(dtype):
    rng = np.random.default_rng(2)
    h1j, h1t = both(rng.standard_normal((2, 7, 172)).astype(np.float32), dtype)
    h3j, h3t = both(rng.standard_normal((2, 7, 172)).astype(np.float32), dtype)
    assert_same(J["swiglu"](h1j, h3j), ref.swiglu(h1t, h3t), DTYPES[dtype][2])


def test_softmax():
    x = np.random.default_rng(3).standard_normal((3, 50)).astype(np.float32) * 4
    assert_same(J["softmax"](jnp.asarray(x)), ref.softmax(torch.from_numpy(x)), F32_TOL)


# ---- samplers ----


@pytest.mark.parametrize(
    "temperature,top_p,mode",
    [(0.0, 0.9, ts.ARGMAX), (0.0, 1.0, ts.ARGMAX), (1.0, 0.0, ts.MULTINOMIAL),
     (0.7, 1.0, ts.MULTINOMIAL), (1.0, 0.9, ts.TOP_P)],
)
def test_choose_mode(temperature, top_p, mode):
    assert ts.choose_mode(temperature, top_p) == js.choose_mode(temperature, top_p) == mode


def test_argmax_first_max_wins():
    logits = np.array([[0.5, 2.0, -1.0, 2.0, 2.0], [3.0, 3.0, 3.0, 3.0, 3.0]], np.float32)
    want = np.asarray(js.sample_argmax(jnp.asarray(logits)))
    got = ts.sample_argmax(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [1, 0])


def _uniform(key, probs):
    """The draw the JAX samplers make from ``key`` (sampling.py:60, :81)."""
    return np.array(jax.random.uniform(key, probs.shape[:-1] + (1,), dtype=jnp.float32))


def _probs(logits, temperature):
    pj = js.probs_from_logits(jnp.asarray(logits), jnp.float32(temperature))
    pt = ts.probs_from_logits(torch.from_numpy(logits), temperature)
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), rtol=2e-5, atol=1e-7)
    return np.array(pj)


@pytest.mark.parametrize("seed", range(4))
def test_multinomial_same_draw(seed):
    logits = np.random.default_rng(seed).standard_normal((1, 512)).astype(np.float32) * 2
    probs = _probs(logits, 0.8)
    for i in range(16):
        key = jax.random.PRNGKey(seed * 100 + i)
        want = int(J_MULTINOMIAL(jnp.asarray(probs), key)[0])
        got = int(ts.sample_multinomial(torch.from_numpy(probs), torch.from_numpy(_uniform(key, probs)))[0])
        assert got == want


@pytest.mark.parametrize("p", [0.5, 0.9, 0.95])
def test_top_p_same_draw(p):
    logits = np.random.default_rng(5).standard_normal((1, 512)).astype(np.float32) * 3
    probs = _probs(logits, 1.0)
    for i in range(16):
        key = jax.random.PRNGKey(i)
        want = int(J_TOP_P(jnp.asarray(probs), jnp.float32(p), key)[0])
        got = int(ts.sample_top_p(torch.from_numpy(probs), p, torch.from_numpy(_uniform(key, probs)))[0])
        assert got == want


def test_top_p_ties_keep_index_order():
    """Tied probabilities sort in ascending index order in both (lax.top_k
    and the stable torch sort), so the same draw picks the same index."""
    logits = np.zeros((1, 64), np.float32)
    logits[0, [3, 9, 20, 41, 57]] = 2.0  # five tied leaders
    logits[0, [5, 6]] = 1.0  # two tied runners-up
    probs = _probs(logits, 1.0)
    picked = set()
    for i in range(48):
        key = jax.random.PRNGKey(1000 + i)
        want = int(J_TOP_P(jnp.asarray(probs), jnp.float32(0.8), key)[0])
        got = int(ts.sample_top_p(torch.from_numpy(probs), 0.8, torch.from_numpy(_uniform(key, probs)))[0])
        assert got == want
        picked.add(got)
    assert len(picked & {3, 9, 20, 41, 57}) >= 3  # the draws really span the tie


@pytest.mark.parametrize("mode", [ts.ARGMAX, ts.MULTINOMIAL, ts.TOP_P])
def test_sample_dispatch(mode):
    logits = np.random.default_rng(7).standard_normal((512,)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = int(js.sample(jnp.asarray(logits), mode, jnp.float32(0.7), jnp.float32(0.9), key))
    r = _uniform(key, logits)
    got = int(ts.sample(torch.from_numpy(logits), mode, 0.7, 0.9, torch.from_numpy(r)))
    assert got == want
