"""The served decode tick's two redesigned kernels on the CPU: the launch
plans (``ops/cuda/mlp_block.py::plan``, the form of K10-K13's products;
``ops/cuda/attention_q8.py::q8_plan``, K16/K18's split loop), a mirror of
the device's cut of a row's keys into splits (``split_keys`` in
``csrc/attention_q8.cuh``), and the split loop's arithmetic emulated in plain
PyTorch (keys dealt to warps and splits, each warp with its own running max,
``bf16(p * v_scale)`` rounded against it, the warps merged in warp order,
then the splits in split order) against the JAX K16 and K18 in interpret
mode, at the bound the card holds the kernels to (the int8-cache tolerance of
``tests/test_torch_kernels_gpu.py``). The kernels themselves run only on the
card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama2_tpu.ops.pallas import attention_q8 as jq8
from llama2_tpu.ops.pallas import paged_attention as jpa
from llama2_tpu_torch.benchmarks.kernels import rope_tables
from llama2_tpu_torch.ops.cuda import attention_q8 as tq8
from llama2_tpu_torch.ops.cuda import build
from llama2_tpu_torch.ops.cuda import mlp_block as mb
from llama2_tpu_torch.ops.cuda import paged_attention as tpa
from test_torch_kernels_gpu import _assert_close, _q8kv_tol

SMS = 132  # the H100's SMs
HEADER = os.path.join(build.CSRC, "attention_q8.cuh")
W7B = (4096, 11008, 12288)  # D, HD, Dq


def header_constant(name: str) -> int:
    with open(HEADER) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


# ---------------------------------------------------------------- K10-K13


@pytest.mark.parametrize("M,form,mt", [(1, "fma", 1), (2, "fma", 2), (3, "mma", 8), (5, "mma", 8),
                                       (8, "mma", 8), (12, "mma", 8)])
def test_mlp_plan_takes_the_tensor_cores_from_three_rows(M, form, mt):
    """One and two rows keep the FMA form (at two it is the faster on the
    H100); 3 to 8 rows take the tensor-core form in one pass of 8, 12 rows in
    two (8, then 4). The workspace holds a pass (and the tensor-core form's
    staged x rows)."""
    p = mb.plan(M, *W7B, (64, 64, 64, 64), 264)
    assert (p["variant"], p["mt"]) == (form, mt)
    assert all(k >= 1 for k in p["ksplit"])
    D, HD, Dq = W7B
    partial = max(p["ksplit"][0] * D, 2 * p["ksplit"][1] * HD, p["ksplit"][2] * D, p["ksplit"][3] * Dq)
    staged = 8 * (D + HD) // 2 if form == "mma" else 0  # the staged bf16 x rows
    assert p["ws_floats"] == mt * (3 * D + HD + partial) + staged


@pytest.mark.parametrize("groups,widths", [((8, 8, 8, 8), W7B), ((64, 24, 64, 64), W7B),
                                           ((64, 64, 64, 64), (4096, 11000, 12288)),
                                           ((64, 64, 64, 64), (4096, 11008, 12292))])
def test_mlp_plan_keeps_fma_where_groups_or_widths_miss_16(groups, widths):
    """A group size or a width (N) that is no multiple of 16 keeps every row
    count on the FMA form; a phase the launch does not run (group 0) does
    not count."""
    for M in (3, 8, 12):
        assert mb.plan(M, *widths, groups, 264)["variant"] == "fma"
    assert mb.variant(8, 4096, 11008, 12292, (64, 64, 64, 0)) == "mma"  # no qkv phase


# ---------------------------------------------------------------- K16/K18


def split_keys(n_keys: int, nsplit: int, chunk: int) -> tuple[int, int]:
    """The device's ``split_keys``: (ns, per); split s < ns holds keys
    s * per .. min(n_keys, (s + 1) * per) - 1. No key (K13 at pos 0): one
    empty split."""
    n = max(n_keys, 1)
    chunks = -(-n // chunk)
    ns0 = max(1, min(nsplit, chunks))
    per = -(-(-(-n // ns0)) // chunk) * chunk
    return -(-n // per), per


def test_q8_plan_constants_are_the_kernels():
    assert tpa.Q8_WARPS == header_constant("kThreads") // 32
    assert tq8.MAX_SPLITS == header_constant("kMaxSplit")
    assert header_constant("kMaxNQ") == 8


@pytest.mark.parametrize("layout", ["7B", "GQA", "stories15M"])
def test_q8_plan_split_count_comes_from_the_shapes(layout):
    """The split count is a function of (B, H, KVH, reach, hs, SMs), never
    of a position: the served tick at 8 slots takes one split a (b, kv head)
    at the 7B layout and fills the card at batch 1; the workspace holds one
    state of nq * (hs + 2) floats a block, the tickets one a (b, kv head,
    group); every element of a row is some lane's."""
    H, KVH, hs = {"7B": (32, 32, 128), "GQA": (32, 4, 64), "stories15M": (6, 6, 48)}[layout]
    for B in (1, 8):
        p = tpa.q8_plan(B, H, KVH, 4096, hs, SMS)
        groups = B * KVH * p["n_rg"]
        assert p["n_rg"] == -(-(H // KVH) // p["nq"]) and p["nq"] == (1 if H == KVH else 8)
        assert 1 <= p["splits"] <= tq8.MAX_SPLITS
        assert p["grid"] == groups * p["splits"] <= tpa.Q8_BLOCKS_PER_SM * SMS or p["splits"] == 1
        assert p["ws_floats"] == groups * p["splits"] * p["nq"] * (hs + 2)
        assert p["tickets"] == groups <= build.MAX_TICKETS
        assert p["lanes"] * p["nv"] * p["vb"] >= hs and hs % p["vb"] == 0
        assert p["chunk"] == tpa.Q8_WARPS * p["unroll"] * (32 // p["lanes"])
    if layout == "7B":
        assert tpa.q8_plan(8, H, KVH, 4096, hs, SMS)["splits"] == 1
        assert tpa.q8_plan(1, H, KVH, 4096, hs, SMS)["grid"] >= SMS
        assert tpa.q8_plan(8, H, KVH, 4096, hs, SMS)["vb"] == 16
        assert tpa.q8_plan(8, H, KVH, 4096, hs, SMS, aligned=False)["vb"] == 2
    with pytest.raises(ValueError):
        tpa.q8_plan(8, H, KVH, 4096, hs, SMS, splits=tq8.MAX_SPLITS + 1)


def test_split_keys_cover_every_key_once():
    """Each row's keys 0..pos fall into at most nsplit runs of whole chunks
    (the last cut at pos), none empty, whatever pos is."""
    for chunk in (32, 128, 256):
        for nsplit in (1, 3, 8):
            for n_keys in (1, 31, 32, 33, 255, 256, 257, 1000, 4096):
                ns, per = split_keys(n_keys, nsplit, chunk)
                assert 1 <= ns <= nsplit and per % chunk == 0
                runs = [(s * per, min(n_keys, (s + 1) * per)) for s in range(ns)]
                assert runs[0][0] == 0 and runs[-1][1] == n_keys
                assert all(a < b for a, b in runs) and all(runs[i][1] == runs[i + 1][0] for i in range(ns - 1))


def split_loop(q, k8, ks, v8, vs, pos, nsplit: int, chunk: int, scale: float, virtual=None):
    """The int8 split decode loop (K7-K9, K13, K16/K18) in plain PyTorch on
    one layer's rows gathered dense: q (B, H, hs), or a window (B, T, H, hs),
    float32 (bf16 values), k8/v8 (B, KVH, n, hs), ks/vs (B, KVH, n). A kv
    head's query row r = t * G + g sees keys up to pos[b] - (T - 1) + t. With
    ``virtual`` (K13: this step's int8 K and V rows (B, KVH, hs) and their
    (B, KVH) scales) the keys are t < pos[b], and the last split's block
    joins the virtual row after its warps, as one more state: m its score,
    l 1, acc its float32 dequantized value. Row b's keys cut by split_keys;
    within a split, warp w takes passes of chunk / 8 keys at base t_begin +
    w * chunk / 8 + i * chunk, each pass one online-softmax update against
    the warp's running max (p * v_scale rounded to bf16 against it; a row
    that sees no key yet stays empty); the warps' states merge in warp order
    (weight 0 for a warp that saw no key), the splits' in split order.
    Returns float32 shaped like q."""
    q4 = q if q.ndim == 4 else q[:, None]
    B, T, H, hs = q4.shape
    KVH = k8.shape[1]
    G = H // KVH
    R = T * G
    wk = chunk // tpa.Q8_WARPS
    out = torch.zeros(B, R * KVH, hs)
    ninf = float("-inf")

    def merge(states):
        m = torch.stack([s[0] for s in states])  # (n, R)
        M = m.amax(0)
        w = torch.where(m == ninf, torch.zeros_like(m), torch.exp(m - M))
        L = sum(s[1] * w[i] for i, s in enumerate(states))
        o = sum(s[2] * w[i][:, None] for i, s in enumerate(states))
        return M, L, o

    for b in range(B):
        n = int(pos[b]) if virtual is not None else int(pos[b]) + 1
        ns, per = split_keys(n, nsplit, chunk)
        hz = int(pos[b]) - (T - 1) + torch.arange(R) // G  # each query row's last key
        for kvh in range(KVH):
            qg = q4[b, :, kvh * G:(kvh + 1) * G].reshape(R, hs)
            k, v = k8[b, kvh].float(), v8[b, kvh].float()
            kscale = ks[b, kvh] * scale
            splits = []
            for s in range(ns):
                t0, t1 = s * per, min(n, (s + 1) * per)
                states = []
                for w in range(tpa.Q8_WARPS):
                    m = torch.full((R,), ninf)
                    l, acc = torch.zeros(R), torch.zeros(R, hs)
                    for base in range(t0 + w * wk, t1, chunk):
                        t = torch.arange(base, min(base + wk, t1))
                        sc = (qg @ k[t].T) * kscale[t]
                        sc = sc.masked_fill(t[None, :] > hz[:, None], ninf)
                        m_new = torch.maximum(m, sc.amax(-1))
                        m_use = torch.where(m_new == ninf, torch.zeros_like(m_new), m_new)
                        alpha = torch.exp(m - m_use)
                        p = torch.exp(sc - m_use[:, None])
                        l = l * alpha + p.sum(-1)
                        pv = (p * vs[b, kvh, t]).to(torch.bfloat16).float()
                        acc = acc * alpha[:, None] + pv @ v[t]
                        m = m_new
                    states.append((m, l, acc))
                if virtual is not None and s == ns - 1:
                    kn8, kns, vn8, vns = (a[b, kvh] for a in virtual)
                    sv = (qg @ kn8.float()) * (kns * scale)
                    states.append((sv, torch.ones(R), (vn8.float() * vns).expand(R, hs)))
                splits.append(merge(states))
            _, L, o = merge(splits) if ns > 1 else splits[0]
            out[b, kvh * G * T:(kvh + 1) * G * T] = o / L[:, None]
    # (B, KVH, T, G, hs) rows back to the query's (B, T, H, hs)
    out = out.reshape(B, KVH, T, G, hs).permute(0, 2, 1, 3, 4).reshape(B, T, H, hs)
    return out if q.ndim == 4 else out[:, 0]


def _quantized(rng, shape):
    q, s = jq8.quantize_kv_rows(jnp.asarray(rng.standard_normal(shape).astype(np.float32)))
    return np.asarray(q), np.asarray(s)


def _t(a):
    return torch.from_numpy(np.array(a))


# (H, KVH, hs): the 7B layout (one query row a kv head) and GQA (four, in a
# group of eight) at narrow widths; 128-row pages (the JAX int8 kernels' rule)
SPLIT_LAYOUTS = {"7B": (4, 4, 64), "GQA": (8, 2, 32)}


@pytest.mark.parametrize("mode", ["fused", "stacked"])
@pytest.mark.parametrize("layout", sorted(SPLIT_LAYOUTS))
def test_split_loop_vs_jax_int8_paged_kernels(layout, mode):
    """The split loop's arithmetic, at the plan's chunk and three splits,
    against the JAX K18 (fused) or K16 (stacked) in interpret mode: 3 slots
    at pos 0, 259 (a page boundary inside a split) and 300 over a shuffled
    table, held to the int8-cache tolerance elementwise. The appended rows
    are the plain version's (``tests/test_torch_paged_attention.py``)."""
    H, KVH, hs = SPLIT_LAYOUTS[layout]
    page, max_pages, B, layer = 128, 3, 3, 1
    rng = np.random.default_rng(hs + H)
    P = 1 + B * max_pages
    table = rng.permutation(np.arange(1, P)).reshape(B, max_pages).astype(np.int32)
    pos = np.array([0, 2 * page + 3, 300], np.int32)
    wpage = table[np.arange(B), pos // page].astype(np.int32)
    wrow = (pos % page).astype(np.int32)
    k8, ks = _quantized(rng, (2, P, KVH, page, hs))
    v8, vs = _quantized(rng, (2, P, KVH, page, hs))
    pools = (k8, ks, v8, vs)
    jargs = (jnp.asarray(table),)
    coords = (jnp.asarray(wpage), jnp.asarray(wrow), layer, jnp.asarray(pos))
    if mode == "fused":
        qkv = rng.standard_normal((B, H + 2 * KVH, hs)).astype(np.float32)
        cos_il, sin_il = rope_tables(_t(pos), hs)
        want, *jp = jpa.paged_decode_attention_q8_fused(
            jnp.asarray(qkv), *(jnp.asarray(a) for a in pools), *jargs, jnp.asarray(cos_il.numpy()),
            jnp.asarray(sin_il.numpy()), *coords, n_heads=H, interpret=True)
        q = tq8.rope_quantize_plain(_t(qkv), cos_il, sin_il, H)[0]
    else:
        q = _t(rng.standard_normal((B, H, hs)).astype(np.float32))
        kn8, kns = _quantized(rng, (B, KVH, 1, hs))
        vn8, vns = _quantized(rng, (B, KVH, 1, hs))
        want, *jp = jpa.paged_decode_attention_q8_stacked(
            jnp.asarray(q.numpy()), *(jnp.asarray(a) for a in pools), *jargs, jnp.asarray(kn8),
            jnp.asarray(kns), jnp.asarray(vn8), jnp.asarray(vns), *coords, interpret=True)
    # the pools after the append (JAX's), gathered dense for the loop and the bound
    dense = [tpa.gather_pages(_t(a)[layer], _t(table), max_pages) for a in jp]
    plan = tpa.q8_plan(B, H, KVH, max_pages * page, hs, SMS, splits=3)
    qb = q.to(torch.bfloat16).float()
    got = split_loop(qb, *dense, _t(pos), plan["splits"], plan["chunk"], 1.0 / hs**0.5)
    ns = [split_keys(int(p) + 1, plan["splits"], plan["chunk"])[0] for p in pos]
    assert max(ns) > 1  # the split merge runs
    tol = _q8kv_tol(torch.float32, q[:, None], *dense, _t(pos).long()[:, None], lambda t: t[:, 0])
    _assert_close(got, _t(np.asarray(want)), tol, f"split loop vs JAX {mode} {layout}")
