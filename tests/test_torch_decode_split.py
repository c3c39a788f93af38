"""The split form of K2/K4 (``csrc/decode_attention.cuh``: ``attend_split``) on
the CPU: the host's launch plan (``ops/cuda/attention.py::plan``), a mirror of
the device's cut of a row's keys into splits (``split_range``), and the
split-and-merge arithmetic (float32 states per split, merged in split order,
weight 0 for a state that saw no key) against the JAX K2 and K4 in interpret
mode, with the tolerances of ``tests/test_torch_attention.py``. The kernels
themselves run only on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama2_tpu.ops import xla as jops
from llama2_tpu.ops.pallas.attention import flash_decode_attention_fused as jax_k4
from llama2_tpu.ops.pallas.attention import flash_decode_attention_stacked as jax_k2
from llama2_tpu_torch.ops.cuda import attention as fa
from llama2_tpu_torch.ops.cuda import build

SMS = 132  # the H100's SMs
LAYOUTS = {"7B": (32, 32, 128), "GQA": (32, 4, 64), "stories15M": (6, 6, 48)}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
HEADER = os.path.join(build.CSRC, "decode_attention.cuh")


def split_range(n_keys: int, nsplit: int, chunk: int) -> tuple[int, int]:
    """The device's ``split_range``: (ns, per); split s < ns holds keys
    s * per .. min(n_keys, (s + 1) * per) - 1."""
    ns0 = max(1, min(nsplit, -(-n_keys // chunk)))
    per = -(-(-(-n_keys // ns0)) // chunk) * chunk
    return -(-n_keys // per), per


def header_constant(name: str) -> int:
    with open(HEADER) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


def test_plan_constants_are_the_kernels():
    assert fa.WARPS == header_constant("kWarps")
    assert fa.MAX_SPLITS == header_constant("kMaxSplit")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plan_at_the_model_layouts(layout, B, dtype):
    """At batch 1 with 7B heads the grid fills the card; the split count stays
    within the kernel's; the workspace and tickets within build's; every head
    element is some lane's."""
    H, KVH, hs = LAYOUTS[layout]
    p = fa.plan(B, H, KVH, 4096, hs, DTYPES[dtype], SMS)
    splits, Hg, Bg = p["grid"]
    assert (splits, Hg, Bg) == (p["splits"], H, B)
    assert 1 <= splits <= fa.MAX_SPLITS
    assert splits * H * B <= fa.BLOCKS_PER_SM * SMS or splits == 1
    if layout == "7B" and B == 1:
        assert splits * H * B >= SMS
    assert p["tickets"] == B * H <= build.MAX_TICKETS
    assert p["ws_floats"] == B * H * splits * (hs + 2)
    assert p["vec"] == 16 // DTYPES[dtype].itemsize
    assert p["lanes"] in (4, 8, 16, 32) and p["lanes"] * p["vec"] * p["nv"] >= hs
    assert p["chunk"] == fa.WARPS * p["unroll"] * (32 // p["lanes"])


@pytest.mark.parametrize("hs,aligned", [(46, True), (128, False), (256, False), (7, True)])
def test_plan_takes_one_element_a_lane_where_vectors_do_not_fit(hs, aligned):
    p = fa.plan(1, 8, 8, 512, hs, torch.bfloat16, SMS, aligned)
    assert (p["vec"], p["lanes"]) == (1, 32)
    assert p["nv"] * 32 >= hs and p["nv"] in (1, 2, 4, 8)
    assert p["unroll"] == 8 // p["nv"]


@pytest.mark.parametrize("splits", [1, 5, 32])
def test_plan_takes_a_given_split_count(splits):
    """A given split count (``chip_smoke.py --dense-timing``'s sweep) changes
    the grid and the workspace, and nothing of the lane layout."""
    own = fa.plan(1, 32, 32, 4096, 128, torch.bfloat16, SMS)
    p = fa.plan(1, 32, 32, 4096, 128, torch.bfloat16, SMS, True, splits)
    assert (p["splits"], p["grid"], p["ws_floats"]) == (splits, (splits, 32, 1), 32 * splits * 130)
    assert {k: v for k, v in p.items() if k not in ("splits", "grid", "ws_floats")} == {
        k: v for k, v in own.items() if k not in ("splits", "grid", "ws_floats")
    }


@pytest.mark.parametrize("splits", [0, 33])
def test_plan_refuses_a_split_count_the_kernel_cannot_take(splits):
    with pytest.raises(ValueError, match="splits"):
        fa.plan(1, 32, 32, 4096, 128, torch.bfloat16, SMS, True, splits)


def test_plan_is_cached_by_its_arguments():
    """The decode step asks for one plan 32 times: the second ask is a lookup."""
    args = (1, 32, 32, 4096, 128, torch.bfloat16, SMS)
    assert fa.plan(*args) is fa.plan(*args)


def test_plan_at_the_main_path_layout():
    """Eight splits of 64-key chunks at the main path's bf16 7B layout (256
    blocks), one split at 8 rows (256 blocks already)."""
    H, KVH, hs = LAYOUTS["7B"]
    assert fa.plan(1, H, KVH, 4096, hs, torch.bfloat16, SMS)["splits"] == 8
    assert fa.plan(1, H, KVH, 4096, hs, torch.bfloat16, SMS)["chunk"] == 64
    assert fa.plan(8, H, KVH, 4096, hs, torch.bfloat16, SMS)["splits"] == 1


def covered(n_keys, nsplit, chunk):
    ns, per = split_range(n_keys, nsplit, chunk)
    ranges = [(s * per, min(n_keys, (s + 1) * per)) for s in range(ns)]
    return ns, per, ranges


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_ranges_cover_every_key_once(layout, dtype):
    """For every pos of a small cache, and sampled pos of the 4096-row one,
    the counted splits cover keys 0..pos once, in order, none empty, each but
    the last a whole number of chunks."""
    H, KVH, hs = LAYOUTS[layout]
    cases = []
    for S, positions in ((300, range(300)), (4096, [0, 1, 63, 64, 65, 255, 256, 511, 512, 1000, 2047, 4095])):
        p = fa.plan(1, H, KVH, S, hs, DTYPES[dtype], SMS)
        cases += [(p["splits"], p["chunk"], pos) for pos in positions]
    cases += [(n, c, pos) for n in (1, 3, 32) for c in (1, 8) for pos in range(70)]
    for nsplit, chunk, pos in cases:
        ns, per, ranges = covered(pos + 1, nsplit, chunk)
        assert 1 <= ns <= nsplit and per % chunk == 0
        assert all(a < b for a, b in ranges)  # none empty
        assert [t for a, b in ranges for t in range(a, b)] == list(range(pos + 1))


def split_attention(q, k, v, n_keys, nsplit, chunk, empty_state=False):
    """The kernel's arithmetic on one (b, query head): q (hs,) float32,
    scaled; k, v (>= n_keys, hs) float32 rows. Each split's state (m, l,
    acc) over its keys, then the states merged in split order; with
    ``empty_state``, a state that saw no key (m = -inf, l = 0, acc = 0) is
    merged too, at weight 0."""
    ns, per, ranges = covered(n_keys, nsplit, chunk)
    states = []
    for a, b in ranges:
        s = k[a:b] @ q
        m = s.max()
        p = torch.exp(s - m)
        states.append((m, p.sum(), p @ v[a:b]))
    if empty_state:
        states.insert(len(states) // 2, (torch.tensor(-torch.inf), torch.tensor(0.0), torch.zeros_like(q)))
    M = max(m for m, _, _ in states)
    L, acc = torch.tensor(0.0), torch.zeros_like(q)
    for m, l, a in states:
        w = torch.tensor(0.0) if m == -torch.inf else torch.exp(m - M)
        L = L + l * w
        acc = acc + a * w
    return acc / L


def split_decode(q, k_cache, v_cache, layer, pos, nsplit, chunk, empty_state=False):
    """K2/K4's output from the split arithmetic over each row's keys 0..pos[b]
    of the (already appended) cache: q (B, H, hs) float32, scaled."""
    B, H, hs = q.shape
    G = H // k_cache.shape[2]
    out = torch.empty(B, H, hs)
    for b, p in enumerate(pos):
        for h in range(H):
            out[b, h] = split_attention(q[b, h], k_cache[layer, b, h // G].float(),
                                        v_cache[layer, b, h // G].float(), p + 1, nsplit, chunk,
                                        empty_state)
    return out


# (L, B, H, KVH, hs, S, pos): pos 0, pos below the split count, per-row positions
SPLIT_SHAPES = [
    (2, 1, 6, 6, 48, 256, [0]),
    (2, 1, 6, 6, 48, 256, [2]),
    (2, 3, 8, 2, 64, 128, [0, 5, 127]),
    (2, 1, 32, 32, 128, 256, [255]),
]
# (nsplit, chunk): the plan's, and cuts small enough to split short rows
SPLITS = [None, (4, 1), (3, 8)]


def split_params(split, B, H, KVH, S, hs, dtype):
    if split is None:
        p = fa.plan(B, H, KVH, S, hs, dtype, SMS)
        return p["splits"], p["chunk"]
    return split


@pytest.mark.parametrize("split", SPLITS, ids=["plan", "4x1", "3x8"])
@pytest.mark.parametrize("L,B,H,KVH,hs,S,pos", SPLIT_SHAPES)
def test_split_merge_vs_jax_k2(L, B, H, KVH, hs, S, pos, split):
    rng = np.random.default_rng(B * 100 + pos[0] + hs)
    k_cache = rng.standard_normal((L, B, KVH, S, hs)).astype(np.float32)
    v_cache = rng.standard_normal((L, B, KVH, S, hs)).astype(np.float32)
    q = rng.standard_normal((B, 1, H, hs)).astype(np.float32)
    k_new = rng.standard_normal((B, KVH, 1, hs)).astype(np.float32)
    v_new = rng.standard_normal((B, KVH, 1, hs)).astype(np.float32)
    layer = L - 1
    pos_np = np.asarray(pos, np.int32)
    out_j, k_j, v_j = jax_k2(
        jnp.asarray(q), jnp.asarray(k_cache), jnp.asarray(v_cache),
        jnp.asarray(k_new), jnp.asarray(v_new), layer, jnp.asarray(pos_np), interpret=True,
    )
    nsplit, chunk = split_params(split, B, H, KVH, S, hs, torch.float32)
    scaled = torch.from_numpy(q[:, 0]) * (1.0 / hs**0.5)
    got = split_decode(scaled, torch.from_numpy(np.array(k_j)), torch.from_numpy(np.array(v_j)),
                       layer, pos, nsplit, chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(out_j)[:, 0], rtol=2e-5, atol=2e-5)


def rope_tables(pos_np: np.ndarray, hs: int):
    cos, sin = jops.rope_angles(jnp.asarray(pos_np)[:, None], hs)
    return np.array(jnp.repeat(cos[:, 0], 2, -1)), np.array(jnp.repeat(sin[:, 0], 2, -1))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", SPLITS, ids=["plan", "4x1", "3x8"])
@pytest.mark.parametrize("L,B,H,KVH,hs,S,pos", SPLIT_SHAPES[:3])
def test_split_merge_vs_jax_k4(L, B, H, KVH, hs, S, pos, split, cache_dtype):
    """K4: the rotated query (float32, scaled) against the cache with the
    rotated K row and the raw V row appended, the split arithmetic over it."""
    rng = np.random.default_rng(B * 100 + pos[0] + hs)
    jdt, tdt = (jnp.float32, torch.float32) if cache_dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    k_cache = rng.standard_normal((L, B, KVH, S, hs)).astype(np.float32)
    v_cache = rng.standard_normal((L, B, KVH, S, hs)).astype(np.float32)
    qkv = rng.standard_normal((B, H + 2 * KVH, hs)).astype(np.float32)
    layer = L - 1
    pos_np = np.asarray(pos, np.int32)
    cos_il, sin_il = rope_tables(pos_np, hs)
    att_j, k_j, v_j = jax_k4(
        jnp.asarray(qkv, jdt), jnp.asarray(k_cache, jdt), jnp.asarray(v_cache, jdt),
        jnp.asarray(cos_il), jnp.asarray(sin_il), layer, jnp.asarray(pos_np), n_heads=H, interpret=True,
    )
    q, _, _ = fa.rope_rows_plain(torch.from_numpy(qkv).to(tdt), torch.from_numpy(cos_il),
                                 torch.from_numpy(sin_il), H, tdt)
    nsplit, chunk = split_params(split, B, H, KVH, S, hs, tdt)
    kc = torch.from_numpy(np.array(k_j.astype(jnp.float32)))
    vc = torch.from_numpy(np.array(v_j.astype(jnp.float32)))
    got = split_decode(q * (1.0 / hs**0.5), kc, vc, layer, pos, nsplit, chunk).to(tdt)
    tol = dict(rtol=1e-5, atol=1e-5) if tdt == torch.float32 else dict(rtol=2**-7, atol=1e-3)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(att_j.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("n_keys,nsplit,chunk", [(1, 4, 1), (3, 4, 1), (70, 3, 8), (257, 8, 64)])
def test_a_state_that_saw_no_key_merges_at_weight_zero(n_keys, nsplit, chunk):
    """A state with m = -inf, l = 0 merges at weight 0, never exp(-inf - -inf):
    the result is finite and equals the merge without it, bit for bit."""
    g = torch.Generator().manual_seed(n_keys)
    q, k, v = torch.randn(64, generator=g), torch.randn(n_keys, 64, generator=g), torch.randn(n_keys, 64, generator=g)
    plain = split_attention(q, k, v, n_keys, nsplit, chunk)
    with_empty = split_attention(q, k, v, n_keys, nsplit, chunk, empty_state=True)
    assert torch.isfinite(with_empty).all()
    assert torch.equal(plain, with_empty)
    s = k @ q
    want = torch.softmax(s, 0) @ v
    torch.testing.assert_close(plain, want, rtol=2e-5, atol=2e-5)
