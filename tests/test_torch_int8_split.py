"""The dense int8-cache decode loop on the CPU: K7, K8, K9 and the attention
phase of K13 on the split decode loop of ``csrc/attention_q8.cuh`` (the one
K16/K18 run over page pools).

The launch plan (``ops/cuda/attention_q8.py::q8_plan``) over dense planes:
its split count a function of the shapes alone, within ``MAX_SPLITS``; K13's
work items dealt over its cooperative grid (``layer_block.launch_plans``);
``split_keys`` covering every key once at the plan's chunks, and K13's empty
cache at pos 0 as one empty split. Then the loop's arithmetic, emulated in
plain PyTorch (``tests/test_torch_tick_split.py::split_loop``: the per-row
horizon of a window, K13's virtual row joined by the last split with its
float32 value, the warp-order and split-order merges), against the JAX
kernels in interpret mode at the int8-cache tolerance of
``tests/test_torch_kernels_gpu.py``: K7 at T = 4 and T = 12 (two row groups
of eight), K9, and the attention of ``layer_block_stacked`` (the JAX K13,
its ``wo`` the identity, ``w2`` and ``x`` zero, so that its output is
``att`` rounded to bf16), at pos 0 (only the virtual row) and at split
boundaries. The kernels themselves run only on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``)."""

import inspect
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama2_tpu.ops.pallas import attention_q8 as jq8
from llama2_tpu.ops.pallas.layer_block import layer_block_stacked as jax_layer_block
from llama2_tpu.quant import q8 as jq
from llama2_tpu_torch.benchmarks.kernels import rope_tables
from llama2_tpu_torch.ops.cuda import attention_q8 as tq8
from llama2_tpu_torch.ops.cuda import build
from llama2_tpu_torch.ops.cuda import layer_block as lb
from llama2_tpu_torch.ops.cuda import mlp_block as mb
from test_torch_kernels_gpu import _assert_close, _q8kv_tol
from test_torch_tick_split import SMS, _quantized, _t, split_keys, split_loop

W7B = (4096, 11008, 12288)  # D, HD, Dq
GROUPS = (64, 64, 64, 64)
HEADER = os.path.join(build.CSRC, "attention_q8.cuh")


def header_instances(macro: str) -> set:
    """The (vb, nq, lanes, nv) of each X(index, VB, LPR, NV, NQ) in ``macro``."""
    with open(HEADER) as f:
        body = re.search(rf"#define {macro}\(X\)((?:.*\\\n)*.*)", f.read()).group(1)
    return {(vb, nq, lpr, nv) for _, vb, lpr, nv, nq in
            (map(int, m) for m in re.findall(r"X\((\d+), (\d+), (\d+), (\d+), (\d+)\)", body))}


def plan_instance(p: dict) -> tuple:
    return p["vb"], p["nq"], p["lanes"], p["nv"]


# ---------------------------------------------------------------- the plan


def test_q8_plan_takes_no_position():
    """The plan's arguments are shapes, the SM count and the launch's grid:
    no position, which lives on the device."""
    assert "pos" not in inspect.signature(tq8.q8_plan).parameters
    assert lb.launch_plans.cache_info is not None and tq8.q8_plan.cache_info is not None  # lru-cached


@pytest.mark.parametrize("T,H,KVH,hs,nq,n_rg", [(1, 32, 32, 128, 1, 1), (4, 32, 32, 128, 4, 1),
                                               (2, 32, 32, 128, 4, 1), (12, 32, 32, 128, 8, 2),
                                               (1, 32, 4, 64, 8, 1), (4, 32, 4, 64, 8, 4),
                                               (1, 32, 8, 128, 4, 1), (16, 6, 6, 48, 8, 2)])
def test_dense_plan_groups_query_rows(T, H, KVH, hs, nq, n_rg):
    """A kv head's T * H / KVH query rows: one a block at T = 1 and the 7B
    layout, up to four in one block (a verify window of 4), else groups of
    eight (a 9-16-row window at the 7B layout is two groups); every element
    of a row is some lane's; the split count within
    1..MAX_SPLITS, the items within the blocks unless one split each
    already fills them, and the workspace one state a (b, kv head, group,
    split)."""
    for B in (1, 8):
        p = tq8.q8_plan(B, H, KVH, 4096, hs, SMS, T=T)
        assert (p["nq"], p["n_rg"]) == (nq, n_rg)
        assert p["lanes"] * p["nv"] * p["vb"] >= hs and hs % p["vb"] == 0
        assert 1 <= p["splits"] <= tq8.MAX_SPLITS
        groups = B * KVH * n_rg
        assert p["grid"] == groups * p["splits"]
        assert p["grid"] <= tq8.Q8_BLOCKS_PER_SM * SMS or p["splits"] == 1
        assert p["ws_floats"] == p["grid"] * nq * (hs + 2) and p["tickets"] == groups <= build.MAX_TICKETS


def test_every_plan_names_an_instance_the_kernels_carry():
    """Whatever the layout, window, alignment and unroll, the plan names one
    of the header's instances (LLAMA2_Q8A_INSTANCES). With ``megakernel``
    (K13) it names the whole-layer kernel's one loop (one query row a block,
    16-byte loads, 8 lanes a row; a GQA kv head's query rows each a group),
    and refuses the head sizes and alignments that loop does not take, as
    ``layer_block_supported`` does."""
    every = header_instances("LLAMA2_Q8A_INSTANCES")
    assert len(every) == 11 and (16, 1, 8, 1) in every
    with open(HEADER) as f:
        assert re.search(r"constexpr int kLayerVB = 16, kLayerLanes = 8,", f.read())
    for H, KVH in ((32, 32), (32, 8), (32, 4), (6, 6), (8, 2)):
        for hs in (32, 46, 48, 64, 96, 128, 136, 256):
            for aligned in (True, False):
                for T in (1, 2, 4, 12, 16):
                    assert plan_instance(tq8.q8_plan(1, H, KVH, 4096, hs, SMS, aligned, T=T)) in every
                for unroll1 in (2, 4):
                    if aligned and hs % 16 == 0 and hs <= 128:
                        p = tq8.q8_plan(1, H, KVH, 4096, hs, SMS, aligned, unroll1=unroll1, megakernel=True)
                        assert plan_instance(p) == (16, 1, 8, 1) and p["n_rg"] == H // KVH
                        assert p["chunk"] == tq8.Q8_WARPS * unroll1 * 4
                    else:
                        with pytest.raises(ValueError):
                            tq8.q8_plan(1, H, KVH, 4096, hs, SMS, aligned, unroll1=unroll1, megakernel=True)


def test_dense_plan_split_count_comes_from_the_shapes():
    """Two calls with the same shapes give the same plan whatever the
    positions will be; a cache of another length or another batch may give
    another. At batch 1 and the 7B layout the launch about fills the card
    (K8/K9: 8 splits of 512 keys), at 8 rows one split a (b, kv head)."""
    one = tq8.q8_plan(1, 32, 32, 4096, 128, SMS)
    assert one == tq8.q8_plan(1, 32, 32, 4096, 128, SMS)
    assert (one["splits"], one["chunk"], one["grid"]) == (8, 128, 256)
    assert tq8.q8_plan(8, 32, 32, 4096, 128, SMS)["splits"] == 1
    assert tq8.q8_plan(1, 32, 32, 256, 128, SMS)["splits"] == 1  # a short cache: 2 chunks, half a split's floor
    assert tq8.q8_plan(1, 32, 32, 4096, 128, SMS, aligned=False)["vb"] == 2
    with pytest.raises(ValueError):
        tq8.q8_plan(1, 32, 32, 4096, 128, SMS, splits=0)


@pytest.mark.parametrize("M,grid,form", [(1, 396, "fma"), (2, 396, "fma"), (3, 264, "mma"), (8, 264, "mma")])
def test_k13_items_cover_its_grid(M, grid, form):
    """K13's attention phase deals its (b, kv head, group, split) items over
    the megakernel's cooperative grid round-robin: every item goes to one
    block, the blocks' loads differ by one item at most, and the plan takes
    as many splits as fit one round (at most MAX_SPLITS, each at least four
    chunks of the full cache). Three blocks an SM at 1-2 rows take two warp
    loads a pass (the registers they share), the tensor-core form four."""
    assert mb.plan(M, *W7B, GROUPS, grid)["variant"] == form
    unroll1 = 2 if form == "fma" else 4
    p = tq8.q8_plan(M, 32, 32, 4096, 128, SMS, blocks=grid, unroll1=unroll1, megakernel=True)
    assert p["unroll"] == unroll1 and p["chunk"] == tq8.Q8_WARPS * unroll1 * 4
    items = p["grid"]
    dealt = [list(range(blk, items, grid)) for blk in range(grid)]
    assert sorted(i for d in dealt for i in d) == list(range(items))
    assert max(map(len, dealt)) - min(map(len, dealt)) <= 1
    groups = M * 32
    assert items <= grid or p["splits"] == 1
    floor = -(-4096 // (4 * p["chunk"]))
    assert p["splits"] == max(1, min(tq8.MAX_SPLITS, floor, grid // groups))
    if M == 1:
        assert items > grid - groups  # one more split would not fit


@pytest.mark.parametrize("unroll1", [2, 4])
@pytest.mark.parametrize("T,H,KVH,hs", [(1, 32, 32, 128), (4, 32, 32, 128), (1, 32, 4, 64)])
def test_split_keys_cover_every_key_once_at_the_dense_chunks(T, H, KVH, hs, unroll1):
    """At the plan's chunk, each row's keys 0..n - 1 fall into at most
    nsplit runs of whole chunks, none empty; K13 at pos 0 (no key) takes one
    empty run, whose block still joins the virtual row."""
    p = tq8.q8_plan(1, H, KVH, 4096, hs, SMS, T=T, unroll1=unroll1)
    chunk = p["chunk"]
    for nsplit in (1, 3, p["splits"]):
        for n_keys in (1, 2, chunk - 1, chunk, chunk + 1, 255, 256, 1000, 4095, 4096):
            ns, per = split_keys(n_keys, nsplit, chunk)
            assert 1 <= ns <= nsplit and per % chunk == 0
            runs = [(s * per, min(n_keys, (s + 1) * per)) for s in range(ns)]
            assert runs[0][0] == 0 and runs[-1][1] == n_keys
            assert all(a < b for a, b in runs) and all(runs[i][1] == runs[i + 1][0] for i in range(ns - 1))
        ns, per = split_keys(0, nsplit, chunk)
        assert ns == 1 and min(0, per) == 0


# ---------------------------------------------------------------- against JAX


def _bf16(t):
    return t.to(torch.bfloat16).float()


@pytest.mark.parametrize("T,H,KVH,hs", [(4, 4, 4, 64), (4, 8, 2, 32), (12, 2, 2, 64)])
def test_window_loop_vs_jax_k7(T, H, KVH, hs):
    """K7's windows on the split loop: row t of a window sees keys up to
    pos - (T - 1) + t, the mask per query row inside the last pass; T = 12
    at one query row a kv head is two row groups of the plan. Three splits,
    two rows at their own positions (one whose window starts at key 0),
    against the JAX K7 in interpret mode at the int8-cache tolerance."""
    S, B = 256, 2
    rng = np.random.default_rng(T * 100 + H)
    q = rng.standard_normal((B, T, H, hs)).astype(np.float32)
    k8, ks = _quantized(rng, (B, KVH, S, hs))
    v8, vs = _quantized(rng, (B, KVH, S, hs))
    pos = np.array([T - 1, 200], np.int32)
    want = jq8.flash_decode_attention_q8(jnp.asarray(q), *(jnp.asarray(a) for a in (k8, ks, v8, vs)),
                                         jnp.asarray(pos), interpret=True)
    plan = tq8.q8_plan(B, H, KVH, S, hs, SMS, splits=3, T=T)
    assert plan["n_rg"] == -(-T * (H // KVH) // plan["nq"]) and plan["nq"] == (4 if T * H // KVH <= 4 else 8)
    cache = [_t(a) for a in (k8, ks, v8, vs)]
    got = split_loop(_bf16(_t(q)), *cache, _t(pos), plan["splits"], plan["chunk"], 1.0 / hs**0.5)
    assert split_keys(201, plan["splits"], plan["chunk"])[0] > 1  # the split merge runs
    horizon = _t(pos).long()[:, None] - (T - 1) + torch.arange(T)[None, :]
    tol = _q8kv_tol(torch.float32, _t(q), *cache, horizon)
    _assert_close(got, _t(np.asarray(want)), tol, f"window loop vs JAX K7 T={T}")


@pytest.mark.parametrize("H,KVH,hs", [(4, 4, 128), (8, 2, 64)])
def test_append_loop_vs_jax_k9(H, KVH, hs):
    """K9 on the split loop: this step's row is key pos, made by the last
    split's block and read from shared memory; pos 0, a chunk boundary and
    one past it, against the JAX K9 in interpret mode (the loop reads the
    rows JAX appended)."""
    L, S, B, layer = 2, 256, 3, 1
    rng = np.random.default_rng(hs + H)
    k8, ks = _quantized(rng, (L, B, KVH, S, hs))
    v8, vs = _quantized(rng, (L, B, KVH, S, hs))
    qkv = rng.standard_normal((B, H + 2 * KVH, hs)).astype(np.float32)
    plan = tq8.q8_plan(B, H, KVH, S, hs, SMS, splits=3)
    pos = np.array([0, plan["chunk"] - 1, plan["chunk"]], np.int32)
    cos_il, sin_il = rope_tables(_t(pos), hs)
    want, *jc = jq8.flash_decode_attention_q8_fused(
        jnp.asarray(qkv), *(jnp.asarray(a) for a in (k8, ks, v8, vs)), jnp.asarray(cos_il.numpy()),
        jnp.asarray(sin_il.numpy()), layer, jnp.asarray(pos), n_heads=H, interpret=True)
    q = tq8.rope_quantize_plain(_t(qkv), cos_il, sin_il, H)[0]
    cache = [_t(np.asarray(a))[layer] for a in jc]
    got = split_loop(_bf16(q), *cache, _t(pos), plan["splits"], plan["chunk"], 1.0 / hs**0.5)
    assert split_keys(int(pos[-1]) + 1, plan["splits"], plan["chunk"])[0] == 2  # key pos alone in split 2
    tol = _q8kv_tol(torch.float32, q[:, None], *cache, _t(pos).long()[:, None], lambda t: t[:, 0])
    _assert_close(got, _t(np.asarray(want)), tol, f"append loop vs JAX K9 H={H} KVH={KVH}")


def _identity_layer(rng, L, D, HD, Dq, G=64):
    """JAX K13's weights for reading its attention off its output: wo the
    identity (64 * 2^-6), w2 zero, the others random."""
    def qt(q, scale):
        return jq.QuantTensor(q=jnp.asarray(q), scale=jnp.asarray(scale), group_size=G)

    def rand(K, N):
        return qt(rng.integers(-127, 128, (L, K, N)).astype(np.int8),
                  rng.uniform(1e-4, 4e-4, (L, K // G, N)).astype(np.float32))

    eye = np.broadcast_to((64 * np.eye(D)).astype(np.int8), (L, D, D)).copy()
    wo = qt(eye, np.full((L, D // G, D), 2.0**-6, np.float32))
    w2 = qt(np.zeros((L, HD, D), np.int8), np.ones((L, HD // G, D), np.float32))
    rms = jnp.asarray(1 + 0.1 * rng.standard_normal((L, D)).astype(np.float32))
    return wo, rms, rand(D, HD), rand(D, HD), w2, rms, rand(D, Dq)


@pytest.mark.parametrize("H,KVH", [(2, 2), (4, 2)])
def test_virtual_row_loop_vs_jax_layer_block(H, KVH):
    """K13's attention phase on the split loop: the cache read with t < pos,
    this step's row joined by the last split's block as a virtual row with
    its float32 dequantized value; at pos 0 (no key: one empty split, the
    virtual row alone), at a split boundary (65: key 64 alone in the second
    split, with the virtual row), at a chunk boundary and mid-split, two
    warp loads a pass (K13's instance at 1-2 rows) and three splits. Held
    against the JAX whole-layer kernel in interpret mode, whose output with
    an identity wo, zero w2 and zero x is bf16(att): both rounded to bf16,
    one flip of the last bit beside the int8-cache tolerance."""
    hs, S, L, layer, B = 128, 256, 2, 1, 2
    D, HD = H * hs, 256
    Dq = (H + 2 * KVH) * hs
    rng = np.random.default_rng(H * 10 + KVH)
    k8, ks = _quantized(rng, (L, B, KVH, S, hs))
    v8, vs = _quantized(rng, (L, B, KVH, S, hs))
    qkv = rng.standard_normal((B, H + 2 * KVH, hs)).astype(np.float32)
    weights = _identity_layer(rng, L, D, HD, Dq)
    plan = tq8.q8_plan(B, H, KVH, S, hs, SMS, splits=3, unroll1=2, megakernel=True)
    for pos in (np.array([0, 65], np.int32), np.array([plan["chunk"], 200], np.int32)):
        cos_il, sin_il = rope_tables(_t(pos), hs)
        out, _, *jc = jax_layer_block(
            jnp.asarray(qkv), jnp.zeros((B, D), jnp.float32), *(jnp.asarray(a) for a in (k8, ks, v8, vs)),
            jnp.asarray(cos_il.numpy()), jnp.asarray(sin_il.numpy()), *weights, jnp.int32(layer),
            jnp.asarray(pos), n_heads=H, with_qkv=False, interpret=True)
        q, rows = tq8.rope_quantize_plain(_t(qkv), cos_il, sin_il, H)
        cache = [_t(a)[layer] for a in (k8, ks, v8, vs)]
        got = split_loop(_bf16(q), *cache, _t(pos), plan["splits"], plan["chunk"], 1.0 / hs**0.5, virtual=rows)
        if pos[0] == 0:
            # the virtual row alone: att is its float32 dequantized value, unrounded
            vd = tq8.dequantize_kv(rows[2][0], rows[3][0])  # (KVH, hs)
            assert torch.equal(got[0], vd.repeat_interleave(H // KVH, 0))
        else:
            assert split_keys(int(pos[0]), plan["splits"], plan["chunk"])[0] == 1
        assert split_keys(int(pos[1]), plan["splits"], plan["chunk"])[0] > 1  # the split merge runs
        after = [_t(np.asarray(a))[layer] for a in jc]  # the row at pos appended: the bound's key pos
        tol = _q8kv_tol(torch.float32, q[:, None], *after, _t(pos).long()[:, None], lambda t: t[:, 0].reshape(B, D))
        tol["rtol"] = 2**-7  # both rounded to bf16
        _assert_close(_bf16(got.reshape(B, D)), _t(np.asarray(out)), tol, f"virtual-row loop vs JAX K13 {pos=}")
