"""The Python side of the prefill segment's kernels, on the CPU: which variant
of K1 (``ops/cuda/prefill_attention.py::plan``) and which tile plan of the
M > 8 dequant-matmul in either mode (``ops/cuda/quant_matmul.py::plan``) a
launch takes, at the Llama-2-7B shapes and at small ones, decided before any launch;
and the wrappers' plain versions at the shapes the new tiles cover, against
the JAX kernels (in interpret mode, as the JAX package's tests run them)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from llama2_tpu.ops.pallas.prefill_attention import flash_prefill_attention as jax_k1
from llama2_tpu.ops.pallas.quant_matmul import quant_matmul_stacked as jax_k6
from llama2_tpu.quant import q8 as jq

from llama2_tpu_torch.ops.cuda import prefill_attention as pa
from llama2_tpu_torch.ops.cuda import quant_matmul as qm
from llama2_tpu_torch.quant import q8 as tq

SMS = 132  # the H100's SMs
SMEM_MAX = 232448  # shared memory a block may take on the H100 (227 KB)
LAYOUTS = {"7B": (32, 32, 128), "GQA": (32, 4, 64), "stories15M": (6, 6, 48)}
Q8_7B = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w13": (4096, 22016),
         "w2": (11008, 4096), "wcls": (4096, 32000), "w1": (4096, 11008)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_k1_variant_by_dtype_and_head_size(layout):
    """bf16 with hs % 16 == 0 takes the bf16 tensor-core variant, fp32 with
    hs % 8 == 0 the TF32 one (three passes a product); a head size either
    cannot take stays on FMA."""
    H, KVH, hs = LAYOUTS[layout]
    p = pa.plan(1, 201, H, KVH, hs, torch.bfloat16)
    assert p["variant"] == "mma" and p["warps"] in (1, 2, 4)
    p = pa.plan(1, 201, H, KVH, hs, torch.float32)
    assert p["variant"] == "tf32" and p["warps"] in (1, 2, 4)
    assert pa.plan(1, 201, 8, 8, 40, torch.bfloat16)["variant"] == "fma"
    assert pa.plan(1, 201, 8, 8, 8, torch.bfloat16)["variant"] == "fma"
    assert pa.plan(1, 201, 8, 8, 44, torch.float32) == {**pa.plan(1, 201, 8, 8, 44, torch.float32),
                                                       "variant": "fma", "warps": 0}
    assert pa.plan(1, 201, 8, 8, 40, torch.float32)["variant"] == "tf32"


@pytest.mark.parametrize("T,pos_rows", [(201, 224), (128, 256), (2048, 1024), (1, 32), (16, 32)])
def test_k1_grid_fills_the_card_at_the_7b_layout(T, pos_rows):
    """At the main path's shape (T = 201, H = KVH = 32, hs = 128) the mma
    variant launches at least 132 blocks: 32-row tiles, 224 blocks. Longer
    segments keep 64-row tiles; a short one cannot fill the card and takes
    the smallest tile that covers it in whole warps."""
    H, KVH, hs = LAYOUTS["7B"]
    p = pa.plan(1, T, H, KVH, hs, torch.bfloat16)
    KV, tiles, B = p["grid"]
    assert (KV, B) == (KVH, 1) and KV * tiles * B == pos_rows
    assert tiles * 16 * p["warps"] >= T  # every row covered
    if T >= 201:
        assert KV * tiles * B >= SMS


@pytest.mark.parametrize("T,tiles,splits", [(201, 7, 1), (128, 8, 1), (2048, 32, 1), (5, 1, 9), (1, 1, 9)])
def test_k1_tf32_grid_fills_the_card_at_the_7b_layout(T, tiles, splits):
    """The fp32 variant's grid at the 7B layout: as the bf16 one, 32-row tiles
    and 224 blocks at the main path's chunk, 64-row tiles at long segments.
    A verify window (T = 5) is one 16-row tile a head, 32 tiles in all, so
    each tile's keys are cut over 9 blocks: at least 132 blocks in every
    case. A block has 4 warps, its row groups' keys cut into slices to make
    up the rest."""
    H, KVH, hs = LAYOUTS["7B"]
    p = pa.plan(1, T, H, KVH, hs, torch.float32)
    assert p["variant"] == "tf32" and p["grid"] == (KVH * splits, tiles, 1) and p["splits"] == splits
    assert tiles * 16 * p["warps"] >= T
    assert KVH * splits * tiles >= SMS
    assert p["warps"] * p["slices"] == 4
    assert 2 * p["smem"] <= SMEM_MAX  # two blocks fit an SM's shared memory


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_k1_key_splits_only_where_the_row_tiles_cannot_fill_the_card(layout):
    """Only the tf32 variant cuts keys over blocks, only where its row tiles
    launch fewer than 132 blocks, at most 16 ways, to about two blocks an
    SM."""
    H, KVH, hs = LAYOUTS[layout]
    for T in (1, 2, 5, 7, 16, 128, 201, 300, 2048):
        for B in (1, 2):
            p = pa.plan(B, T, H, KVH, hs, torch.float32)
            blocks = B * KVH * p["grid"][1]
            if blocks >= SMS:
                assert p["splits"] == 1
            else:
                assert p["splits"] == min(16, -(-2 * SMS // blocks))
            # the runs' workspace: (B, KVH, row tiles, splits, rows, hs_pad + 2) floats
            hs_pad = 64 if hs <= 64 else 128
            assert p["ws"] == (0 if p["splits"] == 1 else blocks * p["splits"] * 16 * p["warps"] * (hs_pad + 2))
            assert pa.plan(B, T, H, KVH, hs, torch.bfloat16)["splits"] == 1
    assert pa.plan(1, 5, 8, 8, 44, torch.float32)["splits"] == 1  # fma


@pytest.mark.parametrize("hs", [16, 44, 48, 64, 96, 128, 176, 256])
@pytest.mark.parametrize("T", [1, 201, 4096])
def test_k1_shared_memory_fits(hs, T):
    """Every head size the wrapper takes fits a block's shared memory, in
    every variant."""
    for dtype in (torch.bfloat16, torch.float32):
        p = pa.plan(2, T, 32, 8, hs, dtype)
        assert 0 < p["smem"] <= SMEM_MAX


def test_k1_cpu_tensors_take_the_plain_version_and_count_nothing():
    g = np.random.default_rng(0)
    q = torch.from_numpy(g.standard_normal((1, 5, 4, 32), np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(g.standard_normal((1, 2, 16, 32), np.float32)).to(torch.bfloat16)
    counters = ("launches", "launches_mma", "launches_tf32", "launches_fma")
    before = [getattr(pa.flash_prefill_attention, c) for c in counters]
    got = pa.flash_prefill_attention(q, k, k, 3)
    assert torch.equal(got, pa.flash_prefill_attention_plain(q, k, k, 3))
    assert torch.equal(pa.flash_prefill_attention(q.float(), k.float(), k.float(), 3),
                       pa.flash_prefill_attention_plain(q.float(), k.float(), k.float(), 3))
    assert before == [getattr(pa.flash_prefill_attention, c) for c in counters]


@pytest.mark.parametrize("M", [9, 64, 128, 129, 201, 256, 300])
def test_wgmma_tile_plan_at_the_7b_shapes(M):
    """The fast M > 8 tile: 128-row tiles (M = 201 in 2, so each weight byte is
    streamed at most twice), 128 columns, at least 132 blocks on every 7B
    shape (K split by whole groups, no split left empty), within the
    shared memory of a block and the tickets of a split reduction."""
    for K, N in Q8_7B.values():
        p = qm.plan(M, K, N, 64, "fast")
        rows, cols = p["tiles"]
        assert p["mt"] == 0 and rows == -(-M // 128) and cols == -(-N // 128)
        if M == 201:
            assert rows == 2
        KG = K // 64
        per = -(-KG // p["ksplit"])
        assert (p["ksplit"] - 1) * per < KG  # the last split has groups
        assert rows * cols * p["ksplit"] >= SMS
        assert p["ksplit"] == 1 or rows * cols < SMS  # split only to fill the card
        assert p["smem"] <= SMEM_MAX


@pytest.mark.parametrize("M", [9, 201, 300])
def test_accurate_tile_plan_at_the_7b_shapes(M):
    """Accurate mode takes the same tile and grid as fast mode, with x in
    three bf16 planes and a 3-stage ring that fits a block's shared memory;
    bf16 rows with no prologue are one exact plane (the fast tile's ring)."""
    for K, N in Q8_7B.values():
        fast, acc = qm.plan(M, K, N, 64, "fast"), qm.plan(M, K, N, 64, "accurate")
        assert {**acc, "planes": 1, "smem": fast["smem"]} == fast
        assert acc["planes"] == 3 and fast["smem"] < acc["smem"] <= SMEM_MAX
        assert qm.plan(M, K, N, 64, "accurate", 1) == fast
    assert qm.x_planes("accurate", torch.float32, None) == 3
    assert qm.x_planes("accurate", torch.bfloat16, torch.ones(4)) == 3
    assert qm.x_planes("accurate", torch.bfloat16, None) == 1
    assert qm.x_planes("fast", torch.float32, torch.ones(4)) == 1


@pytest.mark.parametrize("K,N,G", [(172, 72, 4), (256, 1376, 8), (512, 100, 32), (384, 260, 128)])
def test_wgmma_tile_plan_at_small_shapes(K, N, G):
    """Odd groups and ragged N still take the tile, in both modes, split only
    as far as whole groups allow."""
    for M in (9, 40, 201):
        p = qm.plan(M, K, N, G, "fast")
        KG = K // G
        assert 1 <= p["ksplit"] <= KG and p["tiles"] == (-(-M // 128), -(-N // 128))
        assert (p["ksplit"] - 1) * -(-KG // p["ksplit"]) < KG
    # accurate mode splits K as fast mode does: the same tile
    assert qm.plan(201, K, N, G, "accurate")["ksplit"] == qm.plan(201, K, N, G, "fast")["ksplit"]


def test_wgmma_prologue_is_decided_before_the_launch():
    """x is read as it is only when it is bf16, needs no norm, is 16-byte
    aligned and its tiles are whole 64-row groups; otherwise the prologue
    writes its bf16 rows to the workspace first."""
    x = torch.zeros(2, 16, 4096, dtype=torch.bfloat16)
    assert not qm.needs_prologue(x[0], 64, None)
    assert qm.needs_prologue(x[0], 64, torch.ones(4096, dtype=torch.bfloat16))
    assert qm.needs_prologue(x[0].float(), 64, None)
    assert qm.needs_prologue(x[0], 32, None)
    assert qm.needs_prologue(x.reshape(-1)[4:4 + 4096 * 8].reshape(8, 4096), 64, None)  # 8-byte offset


@pytest.mark.parametrize("M,G,norm", [(9, 8, True), (64, 64, False), (130, 32, True)])
def test_quant_matmul_plain_vs_jax_at_tile_shapes(M, G, norm):
    """The fast mode's plain version, which the card holds the wgmma tile to,
    against the JAX kernel in interpret mode at M just past the decode rows,
    at one 64-row tile and past one 128-row tile, with and without the
    rmsnorm prologue, with the residual epilogue; tolerances of
    ``test_torch_quant_matmul.py`` (the prologue's float32 rows may round
    to bf16 the other way)."""
    g = np.random.default_rng(M + G)
    L, K, N = 2, 128, 96
    w = g.standard_normal((L, K, N)).astype(np.float32) * 0.05
    jt, tt = jq.quantize(w, G), tq.quantize(w, G)
    x = g.standard_normal((M, K)).astype(np.float32)
    rms_w = g.standard_normal(K).astype(np.float32) if norm else None
    res = g.standard_normal((M, N)).astype(np.float32)
    want = np.asarray(jax_k6(jnp.asarray(x), jt, 1, interpret=True, mode="fast",
                             rms_w=None if rms_w is None else jnp.asarray(rms_w), eps=1e-5,
                             residual=jnp.asarray(res)))
    got = qm.quant_matmul_stacked(torch.from_numpy(x), tt, 1, mode="fast",
                                  rms_w=None if rms_w is None else torch.from_numpy(rms_w), eps=1e-5,
                                  residual=torch.from_numpy(res))
    tol = 5e-4 if norm else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("T,pos", [(1, 0), (16, 13)])
def test_prefill_plain_vs_jax_at_short_segments(layout, T, pos):
    """K1's plain version against the JAX kernel in interpret mode at the
    short segments the card tests add (one token; 16 at a prefix), on the
    three head layouts narrowed to two KV heads."""
    H, KVH, hs = LAYOUTS[layout]
    H, KVH = 2 * H // KVH, 2
    g = np.random.default_rng(T + hs)
    S = 64
    q = g.standard_normal((1, T, H, hs)).astype(np.float32)
    k = g.standard_normal((1, KVH, S, hs)).astype(np.float32)
    v = g.standard_normal((1, KVH, S, hs)).astype(np.float32)
    want = jax_k1(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, interpret=True)
    got = pa.flash_prefill_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
