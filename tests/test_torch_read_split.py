"""K3 and K14 on the read-only split form, on the CPU: the host's launch plans
(``ops/cuda/attention.py::read_plan``, K2's ``plan`` at the cache's ``S``;
``ops/cuda/paged_attention.py::fp_plan``'s read form, at the table's reach),
the one-element-a-lane choice, the ticket rule for more (b, query head)
pairs than the workspace has tickets, and the device's read-only blocks
(``split_block_read``) emulated in plain PyTorch: each (b, query head,
split) reads its keys, from the cache only, through the table for K14; its
loads never address a key past its split's last, so never a table entry
past ``pos[b] // page``; float32 states per split merge in split order.
Held against the JAX K3 (per-row and int ``pos``, a given ``scale``) and K14
(a shuffled table whose unused entries name a NaN page) in interpret mode,
at the plan's split count, 3 and 8, with the tolerances of
``tests/test_torch_attention.py`` (1e-5 for float32 outputs, 2^-7 relative
and 1e-3 for bf16 ones). The split mirror and the per-split arithmetic are
``tests/test_torch_decode_split.py``'s. The kernels themselves run only on
the card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama2_tpu.ops.pallas.attention import flash_decode_attention as jax_k3
from llama2_tpu.ops.pallas.paged_attention import paged_decode_attention as jax_k14
from llama2_tpu_torch.ops.cuda import attention as fa
from llama2_tpu_torch.ops.cuda import build
from llama2_tpu_torch.ops.cuda import paged_attention as tpa
from test_torch_decode_split import covered, split_attention

SMS = 132  # the H100's SMs
# 7B heads, the GQA layout of the split tests, the kernel benchmarks' K3 heads
LAYOUTS = {"7B": (32, 32, 128), "GQA": (32, 4, 64), "bench": (32, 4, 128)}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2**-7, atol=1e-3)


def like(shape, dtype, offset=False):
    """A tensor of ``shape`` whose data starts 16-byte aligned, or one element
    past such a start: the plans read shapes and addresses only."""
    base = torch.zeros(2, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    return base[int(offset)].expand(shape)


def read_plans(B, H, KVH, hs, S, page, dtype, offset=False, splits=None):
    """K3's plan over (B, KVH, S, hs) caches and K14's over (P, KVH, page, hs)
    pools with a (B, S // page) table."""
    q = like((B, H, hs), dtype)
    k3 = fa.read_plan(q, like((B, KVH, S, hs), dtype, offset), like((B, KVH, S, hs), dtype, offset), SMS, splits)
    kp = like((5, KVH, page, hs), dtype, offset)
    table = torch.zeros((B, S // page), dtype=torch.int32)
    k14 = tpa.fp_plan(q, kp, kp, None, None, table, H, SMS, False, splits)
    return k3, k14


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_read_plans_are_the_split_forms(layout, B):
    """Both kernels take K2's plan at their reach: S for K3, the table's
    max_pages * page for K14; the grid fills the card at batch 1 and stays
    within two blocks an SM; every head element is some lane's."""
    H, KVH, hs = LAYOUTS[layout]
    for dtype in DTYPES.values():
        k3, k14 = read_plans(B, H, KVH, hs, 4096, 256, dtype)
        assert k3 == k14 == fa.plan(B, H, KVH, 4096, hs, dtype, SMS)
        assert k3["grid"] == (k3["splits"], H, B)
        assert k3["splits"] * H * B <= fa.BLOCKS_PER_SM * SMS or k3["splits"] == 1
        if B == 1:
            assert k3["splits"] * H >= SMS
        assert k3["vec"] == 16 // dtype.itemsize and k3["lanes"] * k3["vec"] * k3["nv"] >= hs


def test_k3_plan_at_the_kernel_benchmarks_shapes():
    """f32, B 1, H 32, KVH 4, hs 128: 8 splits of 32-key chunks, 256 blocks,
    at S 2048 and 8192 alike (the plan reads shapes, not pos)."""
    for S in (2048, 8192):
        k3, _ = read_plans(1, 32, 4, 128, S, 256, torch.float32)
        assert (k3["splits"], k3["chunk"], k3["grid"]) == (8, 32, (8, 32, 1))


@pytest.mark.parametrize("what", ["hs46", "offset"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_read_plans_take_one_element_a_lane_where_vectors_do_not_fit(what, dtype):
    """A head size no 16-byte vector divides, or caches and pools one element
    off 16-byte alignment, take the one-element-a-lane loop; an aligned q
    alone does not decide it."""
    hs = 46 if what == "hs46" else 128
    for p in read_plans(1, 8, 2, hs, 512, 128, DTYPES[dtype], offset=what == "offset"):
        assert (p["vec"], p["lanes"]) == (1, 32) and p["nv"] * 32 >= hs
        assert p["unroll"] == 8 // p["nv"]


def test_more_pairs_than_tickets_take_one_split():
    """B * H past ``build.MAX_TICKETS``: the plan's split count is 1, which
    takes no ticket, so the old kernels' any-B * H shapes are taken; more
    splits there are refused before any launch."""
    H = 32
    B = build.MAX_TICKETS // H + 1
    for p in read_plans(B, H, 4, 64, 64, 16, torch.float32):
        assert p["splits"] == 1
    p = read_plans(B, H, 4, 64, 64, 16, torch.float32, splits=2)[0]
    with pytest.raises(ValueError, match="tickets"):
        fa.split_workspace(torch.device("cpu"), p, B * H)


# ---------------------------------------------------------------- the blocks


def read_keys(t_begin: int, t_end: int, chunk: int) -> list[int]:
    """The keys one block's loads address: 8 warps in passes of chunk / 8
    keys, warp w from t_begin + w * chunk / 8, a key past t_end re-reading
    key t_end - 1 (``attend_split``'s clamp)."""
    wk = chunk // 8
    keys = []
    for w in range(8):
        for base in range(t_begin + w * wk, t_end, 8 * wk):
            keys += [min(base + j, t_end - 1) for j in range(wk)]
    return keys


def emulate(q, rows, pos, nsplit, chunk, G):
    """The read-only blocks of one launch: q (B, H, hs) float32, scaled;
    ``rows(b, kvh, t)`` the float32 rows of keys t of (b, kv head). Block
    (b, h, split) reads the keys of its split (checked: none past pos[b]);
    the splits' states merge in order."""
    B, H, hs = q.shape
    out = torch.empty(B, H, hs)
    for b, p in enumerate(pos):
        _, _, ranges = covered(p + 1, nsplit, chunk)
        for a, e in ranges:
            assert max(read_keys(a, e, chunk)) <= p
        for kvh in range(H // G):
            t = torch.arange(p + 1)
            k, v = rows(b, kvh, t)
            for h in range(kvh * G, (kvh + 1) * G):
                out[b, h] = split_attention(q[b, h], k, v, p + 1, nsplit, chunk)
    return out


def split_count(split, plan):
    return plan["splits"] if split == "plan" else split


# (B, H, KVH, hs, S, pos, scale): an int pos at the default scale, per-row
# positions at a given scale, grouped heads with rows at either end
K3_CASES = {
    "int-pos": (1, 6, 6, 48, 256, 200, None),
    "per-row-scale": (3, 8, 2, 64, 128, [0, 70, 127], 0.3),
    "gqa-ends": (2, 8, 1, 32, 300, [299, 17], None),
}


@functools.lru_cache(maxsize=None)
def k3_case(case: str):
    B, H, KVH, hs, S, pos, scale = K3_CASES[case]
    rng = np.random.default_rng(hs + S)
    q = rng.standard_normal((B, 1, H, hs)).astype(np.float32)
    k = rng.standard_normal((B, KVH, S, hs)).astype(np.float32)
    v = rng.standard_normal((B, KVH, S, hs)).astype(np.float32)
    jpos = pos if isinstance(pos, int) else jnp.asarray(np.asarray(pos, np.int32))
    out = jax_k3(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jpos, scale=scale, interpret=True)
    return q, k, v, np.asarray(out)


@pytest.mark.parametrize("split", ["plan", 3, 8])
@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_read_split_vs_jax(case, split):
    """The emulated K3 blocks against the JAX K3 in interpret mode, and the
    wrapper's plain version (the CPU route) against both."""
    B, H, KVH, hs, S, pos, scale = K3_CASES[case]
    q, k, v, want = k3_case(case)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    pos_list = [pos] * B if isinstance(pos, int) else pos
    p = fa.read_plan(tq[:, 0], tk, tv, SMS)
    s = 1.0 / hs**0.5 if scale is None else scale
    got = emulate(tq[:, 0] * s, lambda b, kvh, t: (tk[b, kvh, t], tv[b, kvh, t]), pos_list,
                  split_count(split, p), p["chunk"], H // KVH)
    np.testing.assert_allclose(got.numpy(), want[:, 0], **F32_TOL)
    plain = fa.flash_decode_attention(tq, tk, tv, pos if isinstance(pos, int) else torch.tensor(pos), scale=scale)
    np.testing.assert_allclose(plain.numpy(), want, **F32_TOL)


# (H, KVH, hs, page, max_pages): 128-element heads in 128-row pages; GQA in 256-row pages
K14_CASES = {"mha128": (4, 4, 128, 128, 4), "gqa64": (8, 2, 64, 256, 3)}


def k14_slots(page: int) -> list[int]:
    """pos 0, page - 1, page, a third page's row."""
    return [0, page - 1, page, 2 * page + 40]


@functools.lru_cache(maxsize=None)
def k14_case(case: str, dtype: str):
    """The case's float32 numpy inputs (values of the dtype): the pools hold
    the scratch page 0, the slots' pages 1.. handed out shuffled, and a last
    page of NaNs that every unused table entry names; and the JAX K14's
    output in interpret mode."""
    H, KVH, hs, page, max_pages = K14_CASES[case]
    pos = np.asarray(k14_slots(page), np.int32)
    B = len(pos)
    rng = np.random.default_rng(hs + page)
    need = pos // page + 1
    P = int(need.sum()) + 2
    perm = rng.permutation(np.arange(1, P - 1))
    table = np.full((B, max_pages), P - 1, np.int32)
    at = 0
    for b, n in enumerate(need):
        table[b, :n] = perm[at : at + n]
        at += n
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    rnd = lambda *shape: np.array(jnp.asarray(rng.standard_normal(shape), jdt).astype(jnp.float32))  # noqa: E731
    kp, vp, q = rnd(P, KVH, page, hs), rnd(P, KVH, page, hs), rnd(B, H, hs)
    kp[P - 1], vp[P - 1] = np.nan, np.nan
    out = jax_k14(jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt), jnp.asarray(table),
                  jnp.asarray(pos), interpret=True)
    return dict(q=q, kp=kp, vp=vp, table=table, pos=pos), np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("split", ["plan", 3, 8])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(K14_CASES))
def test_k14_read_split_through_the_table_vs_jax(case, dtype, split):
    """The emulated K14 blocks through a shuffled table whose unused entries
    name a NaN page, against the JAX K14 in interpret mode: finite, within
    the dtype's tolerance; the splits cut the third page's slot inside a
    page at 8 splits."""
    H, KVH, hs, page, max_pages = K14_CASES[case]
    inputs, want = k14_case(case, dtype)
    tdt = DTYPES[dtype]
    t = {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}
    q, kp, vp, table = t["q"].to(tdt), t["kp"].to(tdt), t["vp"].to(tdt), t["table"]
    p = tpa.fp_plan(q, kp, vp, None, None, table, H, SMS, False)
    nsplit = split_count(split, p)

    def rows(b, kvh, keys):
        pages = table[b, keys // page].long()
        assert not (pages == kp.shape[0] - 1).any()  # the NaN page
        return kp[pages, kvh, keys % page].float(), vp[pages, kvh, keys % page].float()

    got = emulate(q.float() * (1.0 / hs**0.5), rows, inputs["pos"].tolist(), nsplit, p["chunk"], H // KVH)
    assert torch.isfinite(got).all()
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    else:
        np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(), want, **BF16_TOL)
    if split == 8:
        _, _, ranges = covered(k14_slots(page)[3] + 1, nsplit, p["chunk"])
        assert any(a % page for a, _ in ranges[1:])
