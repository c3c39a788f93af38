"""K15 and K17 on K2/K4's split form through a page table, on the CPU: the
host's launch plan (``ops/cuda/paged_attention.py::fp_plan``, K2/K4's
``attention.plan`` at the table's reach), and the device's blocks emulated in
plain PyTorch (each (b, query head, split) reads its keys through the table,
a key whose address is the write address from this step's rows; float32
states per split merged in split order; the group's first head's last split
writes the rows back) against the JAX K15 and K17 in interpret mode.

Pools are handed out shuffled (pages of 256 and 128 rows); the slots sit at
pos 0, page - 1, page and a third page's row, whose key range the splits cut
inside pages; one slot is inactive (an all-zero table row: the scratch page
0). Held at the tolerances of ``tests/test_torch_paged_attention.py`` (1e-5,
float32 outputs; pools bit for bit but for K17's rotated K rows, 1e-6) and,
for bf16 outputs, ``tests/test_torch_attention.py``'s (2^-7 relative, 1e-3).
The split mirror and the per-split arithmetic are
``tests/test_torch_decode_split.py``'s. The kernels themselves run only on
the card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama2_tpu.ops import xla as jops
from llama2_tpu.ops.pallas import paged_attention as jpa
from llama2_tpu_torch.ops.cuda import attention as fa
from llama2_tpu_torch.ops.cuda import paged_attention as tpa
from test_torch_decode_split import covered, split_attention

SMS = 132  # the H100's SMs
LAYOUTS = {"7B": (32, 32, 128), "GQA": (32, 4, 64), "stories15M": (6, 6, 48)}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
ATOL = 1e-5  # tests/test_torch_paged_attention.py
ROPED = dict(rtol=1e-6, atol=1e-6)  # K17's rotated K rows: JAX contracts the rotation to FMAs
BF16_TOL = dict(rtol=2**-7, atol=1e-3)  # tests/test_torch_attention.py's bf16 outputs


def operands(B, H, KVH, hs, page, max_pages, dtype, off=()):
    """CPU operands of K15 and K17 (one layer of one page of pool: the plan
    reads shapes and addresses only), the names in ``off`` one element past
    a 16-byte aligned start: (q, qkv, k_pool, v_pool, k_new, v_new, table)."""

    def make(name, *shape):
        n = int(np.prod(shape))
        buf = torch.zeros(n + 1, dtype=dtype)
        assert buf.data_ptr() % 16 == 0  # the allocator's alignment
        return buf[int(name in off) :][:n].view(shape)

    return (make("q", B, H, hs), make("qkv", B, H + 2 * KVH, hs), make("k_pool", 1, 1, KVH, page, hs),
            make("v_pool", 1, 1, KVH, page, hs), make("k_new", B, KVH, 1, hs), make("v_new", B, KVH, 1, hs),
            torch.zeros((B, max_pages), dtype=torch.int32))


def plan_of(kernel, ops, H):
    """fp_plan as K15's or K17's wrapper asks for it."""
    q, qkv, kp, vp, kn, vn, table = ops
    if kernel == "K15":
        return tpa.fp_plan(q, kp, vp, kn, vn, table, H, SMS, False)
    return tpa.fp_plan(qkv, kp, vp, kn, vn, table, H, SMS, True)


@pytest.mark.parametrize("kernel", ["K15", "K17"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fp_plan_is_the_dense_plan_at_the_tables_reach(layout, B, dtype, kernel):
    """K15/K17 take K2/K4's plan with S = max_pages * page: 16-byte vectors,
    one split at 8 slots of 7B heads (256 blocks fill the card twice over
    already), more at one; the workspace and tickets within build's."""
    H, KVH, hs = LAYOUTS[layout]
    page, max_pages, dt = 256, 16, DTYPES[dtype]
    p = plan_of(kernel, operands(B, H, KVH, hs, page, max_pages, dt), H)
    assert p == fa.plan(B, H, KVH, max_pages * page, hs, dt, SMS)
    assert p["vec"] == 16 // dt.itemsize
    assert p["grid"] == (p["splits"], H, B) and 1 <= p["splits"] <= fa.MAX_SPLITS
    assert p["splits"] * H * B <= fa.BLOCKS_PER_SM * SMS or p["splits"] == 1
    assert p["tickets"] == B * H and p["ws_floats"] == B * H * p["splits"] * (hs + 2)
    if layout == "7B":
        assert p["splits"] == (1 if B == 8 else 8)


@pytest.mark.parametrize("kernel", ["K15", "K17"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("what", ["hs46", "k_pool", "v_pool", "k_new", "qkv"])
def test_fp_plan_takes_one_element_a_lane_where_vectors_do_not_fit(what, dtype, kernel):
    """Head size 46 (no 16-byte vector divides it), or an operand the loop
    reads by vectors one element off 16-byte alignment (the pools; K15's
    k_new, K17's qkv), takes the same split loop with one element a lane;
    an operand the other kernel does not read by vectors changes nothing."""
    hs = 46 if what == "hs46" else 128
    dt = DTYPES[dtype]
    p = plan_of(kernel, operands(8, 8, 2, hs, 128, 4, dt, off=(what,)), 8)
    vectors_off = what in ("hs46", "k_pool", "v_pool") or what == {"K15": "k_new", "K17": "qkv"}[kernel]
    assert p["vec"] == (1 if vectors_off else 16 // dt.itemsize)
    if vectors_off:
        assert (p["lanes"], p["unroll"] * p["nv"]) == (32, 8) and p["nv"] * 32 >= hs


def test_fp_plan_follows_the_table_and_a_given_split_count():
    """The split count comes from the table's reach (the shapes), and a given
    count (``_fp_launch``'s ``splits``, the timing sweep's) replaces it."""
    H, KVH, hs = LAYOUTS["7B"]
    full = plan_of("K17", operands(1, H, KVH, hs, 256, 16, torch.bfloat16), H)
    short = plan_of("K17", operands(1, H, KVH, hs, 256, 2, torch.bfloat16), H)
    assert (full["splits"], short["splits"]) == (8, 2)
    q, qkv, kp, vp, kn, vn, table = operands(1, H, KVH, hs, 256, 16, torch.bfloat16)
    assert tpa.fp_plan(qkv, kp, vp, kn, vn, table, H, SMS, True, 3)["splits"] == 3
    with pytest.raises(ValueError, match="splits"):
        tpa.fp_plan(qkv, kp, vp, kn, vn, table, H, SMS, True, 33)


# ---------------------------------------------------------------- the loop

L = 2
# (H, KVH, hs, page, max_pages): heads of 128 (as 7B's), GQA, stories15M's
CASES = {"mha128": (4, 4, 128, 128, 4), "gqa64": (8, 2, 64, 256, 3), "15M": (6, 6, 48, 256, 3)}
KERNELS = [("K15", "f32"), ("K17", "f32"), ("K17", "bf16")]


def slots(page: int) -> list[int]:
    """pos 0, page - 1, page, a third page's row; the last slot inactive."""
    return [0, page - 1, page, 2 * page + 40, 5]


@functools.lru_cache(maxsize=None)
def jax_case(case: str, kernel: str, dtype: str):
    """The case's inputs (float32 numpy, the pools before the call) and the
    JAX kernel's (att, k_pool, v_pool) in interpret mode."""
    H, KVH, hs, page, max_pages = CASES[case]
    pos = np.asarray(slots(page), np.int32)
    B = len(pos)
    rng = np.random.default_rng(hs + page + H)
    P = 1 + (B - 1) * max_pages
    table = rng.permutation(np.arange(1, P)).reshape(B - 1, max_pages)
    table = np.concatenate([table, np.zeros((1, max_pages), np.int64)]).astype(np.int32)
    wpage = table[np.arange(B), pos // page].astype(np.int32)
    wrow = (pos % page).astype(np.int32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    rnd = lambda *shape: np.asarray(jnp.asarray(rng.standard_normal(shape), jdt).astype(jnp.float32))  # noqa: E731
    kp, vp = rnd(L, P, KVH, page, hs), rnd(L, P, KVH, page, hs)
    inputs = dict(pos=pos, table=table, wpage=wpage, wrow=wrow, kp=kp, vp=vp)
    coords = (jnp.asarray(wpage), jnp.asarray(wrow), L - 1, jnp.asarray(pos))
    if kernel == "K15":
        inputs.update(q=rnd(B, H, hs), kn=rnd(B, KVH, 1, hs), vn=rnd(B, KVH, 1, hs))
        out = jpa.paged_decode_attention_stacked(
            jnp.asarray(inputs["q"], jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt), jnp.asarray(table),
            jnp.asarray(inputs["kn"], jdt), jnp.asarray(inputs["vn"], jdt), *coords, interpret=True)
    else:
        cos, sin = jops.rope_angles(jnp.asarray(pos)[:, None], hs)
        cos_il, sin_il = (np.asarray(jnp.repeat(t[:, 0], 2, -1)) for t in (cos, sin))
        inputs.update(qkv=rnd(B, H + 2 * KVH, hs), cos_il=cos_il, sin_il=sin_il)
        out = jpa.paged_decode_attention_fused(
            jnp.asarray(inputs["qkv"], jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt), jnp.asarray(table),
            jnp.asarray(cos_il), jnp.asarray(sin_il), *coords, n_heads=H, interpret=True)
    return inputs, tuple(np.asarray(t.astype(jnp.float32)) for t in out)


def emulate(q, k_pool, v_pool, kn, vn, table, wpage, wrow, layer, pos, nsplit, chunk):
    """The device's blocks of one launch: q (B, H, hs) float32, scaled; the
    pools (L, P, KVH, page, hs) as before the launch; kn, vn (B, KVH, hs)
    this step's rows in the pool dtype. Block (b, h, split) reads keys of
    ``split_range`` through the table, the key at the write address from
    kn/vn; the splits' states merge in order. Returns float32 out, the pools
    after the launch and the (b, kv head) pairs in the order their rows were
    written."""
    B, H, hs = q.shape
    _, P, KVH, page, _ = k_pool.shape
    G = H // KVH
    kf, vf = k_pool.reshape(-1, hs), v_pool.reshape(-1, hs)
    k_after, v_after = k_pool.clone(), v_pool.clone()
    out, written = torch.empty(B, H, hs), []
    for b, p in enumerate(pos.tolist()):
        n_keys = p + 1
        ns, _, ranges = covered(n_keys, nsplit, chunk)
        assert ranges[-1][1] == n_keys  # the last split holds pos
        t = torch.arange(n_keys)
        for kvh in range(KVH):
            addr = ((layer * P + table[b, t // page].long()) * KVH + kvh) * page + t % page
            woff = ((layer * P + int(wpage[b])) * KVH + kvh) * page + int(wrow[b])
            fresh = addr == woff
            k, v = kf[addr].float(), vf[addr].float()
            k[fresh], v[fresh] = kn[b, kvh].float(), vn[b, kvh].float()
            for h in range(kvh * G, (kvh + 1) * G):
                out[b, h] = split_attention(q[b, h], k, v, n_keys, nsplit, chunk)
                for split in range(ns):
                    if h % G == 0 and split == ns - 1:
                        k_after.view(-1, hs)[woff] = kn[b, kvh]
                        v_after.view(-1, hs)[woff] = vn[b, kvh]
                        written.append((b, kvh))
    return out, k_after, v_after, written


def split_params(split, B, H, KVH, S, hs, dtype):
    p = fa.plan(B, H, KVH, S, hs, dtype, SMS)
    return (p["splits"] if split == "plan" else split), p["chunk"]


@pytest.mark.parametrize("split", ["plan", 3, 8])
@pytest.mark.parametrize("kernel,dtype", KERNELS, ids=["K15-f32", "K17-f32", "K17-bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_loop_through_the_table_vs_jax(case, kernel, dtype, split):
    """The emulated blocks against the JAX kernel in interpret mode: the
    active slots' outputs; the pools equal to the plain version's and to
    JAX's, each (b, kv head) row written once, at the write coordinates."""
    H, KVH, hs, page, max_pages = CASES[case]
    inputs, (att_j, k_j, v_j) = jax_case(case, kernel, dtype)
    tdt = DTYPES[dtype]
    t = {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}
    kp, vp = t["kp"].to(tdt), t["vp"].to(tdt)
    B, act = len(inputs["pos"]), len(inputs["pos"]) - 1
    coords = (t["wpage"], t["wrow"], L - 1, t["pos"])
    if kernel == "K15":
        q, kn, vn = t["q"].to(tdt).float(), t["kn"][:, :, 0].to(tdt), t["vn"][:, :, 0].to(tdt)
        plain = tpa.paged_decode_attention_stacked_plain(
            t["q"].to(tdt), kp.clone(), vp.clone(), t["table"], t["kn"].to(tdt), t["vn"].to(tdt), *coords)
    else:
        qkv = t["qkv"].to(tdt)
        q, kn, vn = fa.rope_rows_plain(qkv, t["cos_il"], t["sin_il"], H, tdt)
        plain = tpa.paged_decode_attention_fused_plain(
            qkv, kp.clone(), vp.clone(), t["table"], t["cos_il"], t["sin_il"], *coords, H)
    nsplit, chunk = split_params(split, B, H, KVH, max_pages * page, hs, tdt)
    out, k_after, v_after, written = emulate(q * (1.0 / hs**0.5), kp, vp, kn, vn, t["table"], *coords, nsplit,
                                             chunk)
    assert sorted(written) == [(b, kvh) for b in range(B) for kvh in range(KVH)]
    assert torch.equal(k_after, plain[1]) and torch.equal(v_after, plain[2])
    np.testing.assert_allclose(k_after.float().numpy(), k_j, **(ROPED if kernel == "K17" else dict(rtol=0, atol=0)))
    np.testing.assert_array_equal(v_after.float().numpy(), v_j)
    if dtype == "f32":
        np.testing.assert_allclose(out[:act].numpy(), att_j[:act], rtol=ATOL, atol=ATOL)
    else:
        got = out[:act].to(torch.bfloat16).float().numpy()
        np.testing.assert_allclose(got, att_j[:act], **BF16_TOL)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_edges_fall_inside_pages(case, dtype):
    """The split counts the loop test takes cut the third page's slot into
    whole chunks, and at least one of them at a key inside a page: a split
    reads the end of one page and the start of the next."""
    H, KVH, hs, page, max_pages = CASES[case]
    n_keys = slots(page)[3] + 1
    inside = []
    for split in ("plan", 3, 8):
        nsplit, chunk = split_params(split, 5, H, KVH, max_pages * page, hs, DTYPES[dtype])
        ns, per, ranges = covered(n_keys, nsplit, chunk)
        assert per % chunk == 0 and ranges[-1][1] == n_keys
        inside += [a for a, _ in ranges[1:] if a % page]
    assert inside
