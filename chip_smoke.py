#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``llama2_tpu_torch``) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py

Phases, one or more lines each; any failed check raises, so the run exits
non-zero:

1. card and build: the device name, ``nvidia-smi`` name and power limit, and
   the build of every CUDA kernel from ``llama2_tpu_torch/csrc`` (seconds,
   ptxas registers / shared memory / spills);
2. each kernel against its plain PyTorch version on the card, fp32 and bf16:
   the attention kernels at the Llama-2-7B, a GQA and the stories15M head
   layouts (K1 also at head size 44, which only its FMA variant takes, and
   in fp32 at a 5-token verify window ending at the cache's last row; K2 and K4's split form, also at head size 46 and with operands
   off 16-byte alignment, both its one-element-a-lane loop, at positions 0,
   1, the batch-1 plan's split count less one, 255, 256, 1000 and 4095 and
   per-row at 3 and 8 rows, each with the appends bit-equal, a rerun
   bit-equal and every ticket zero after), the INT8 dequant-matmul kernels at the Llama-2-7B projection
   shapes in both modes at M = 1, 8, 9 and 201 (the M > 8 tile counted by
   mode), the FFN megakernels at the 7B widths and three ragged
   shapes for 1 to 12 rows, each launch in the form its plan names (the
   tensor-core form from 3 rows at groups of 32 and 64); the int8-cache
   attention kernels (K7 windows of
   1, 4 and 16 rows, K8, K9) at the 7B and a GQA layout, and the whole-layer
   kernel (K13) at the 7B widths, against K9 + K12 too, with the cache
   appends bit-equal, and its attention phase alone; the int8-cache
   attention is held to an elementwise bound that faults planted at pos
   4095 (a dropped chunk, a dropped or misweighted split) fail; K4, K9 and
   K13 at the 8 rows of the batched engines, each at its own position; the
   paged kernels K15-K18 over fp and int8 page pools (8 slots, two of them
   inactive on the scratch page, shuffled pages of 256 and 128 rows, layers
   0 and 31, the 7B and a GQA layout), and K15/K17's split form at K2/K4's
   split checks; the kernel benchmarks' kernels: K3
   over one layer's caches at the three layouts with per-row and scalar
   positions, K14 over one layer's shuffled pools whose unused table entries
   name a NaN page, K19 and K20 at the benchmark's and ragged widths, and K3
   and K14 (read only on the split form) at K2/K4's split checks at a given
   scale, K14 also at 3 and 8 splits, the caches and pools unchanged;
3. the served path, this slice's main path: ``PagedBatchEngine`` at full
   Llama-2-7B width and 32 layers, INT8 weights, bf16 activations,
   ``backend="cuda"``, 8 slots, 256-row pages, the prefix cache, serving 16
   requests over a bf16 and over an int8 page pool, with the launches of
   every decode tick asserted (K6 1, K17 or K18 32, K12 31, K11 1, K5 1)
   and every admission prefill's K1 through its tensor-core variant (bf16's
   and, on ``cuda-accurate``, fp32's), every K12 and K11 of a tick (and K13
   of the dense engine's) on the megakernels' tensor-core form, reruns and
   pipeline depth 1 against 2 bit-equal,
   the greedy streams held to their plain replays, ticks profiled at short
   and long positions, and
   the dense ``BatchEngine`` on the same requests for its memory;
   ``cuda-accurate`` in fp32 at 8 layers over both pools (K15, K16). Then
   the earlier main paths: ``Generator.generate`` at full Llama-2-7B width (random
   weights from a seed, built on the card), a ~200-token prompt and 64 greedy
   tokens. INT8 (Q8) weights, ``backend="cuda"``, bf16 activations, all 32
   layers: over the fp cache (the 2-launch decode layer: glue-fused attention
   + the wo/FFN/next-QKV megakernel) and over the int8 KV cache (this slice's
   main path: one whole-layer launch a layer), each also with speculative
   decoding (4-token verify windows), and over the int8 cache with the
   whole-layer kernel switched off (K9 + K12), each profiled at positions
   0-16 and 4080-4095; ``cuda-accurate`` in fp32 over the fp cache, with
   speculative decoding. Over 8 layers the int8 cache's other routes
   (``cuda-accurate`` in fp32 with K8, with speculative decoding; bf16
   weights with K8), fp32 activations on the 2-launch route and the composed
   dequant-matmul route (the ``w13`` layout); a 2-layer model whose ``wo``
   is left in bf16, which takes the FFN-only megakernel. bf16 and fp32
   weights: ``backend="cuda"``, 8 layers. Each with launch counts per
   prefill chunk and decode step (per verify trip for speculative decoding;
   K1's by variant: bf16 and fp32 each on its tensor-core variant; the
   accurate routes' prefill-chunk K6 on the accurate M > 8 tile),
   a teacher-forced replay of the same token stream through
   ``backend="torch"`` (the plain versions) over the same kind of cache,
   compared logit by logit, decode tok/s, TTFT and peak memory; each
   speculative run's tokens held bit for bit to a replay of its own verify
   windows, and a second run with drafts from its own stream;
4. the CLI entry point ``python -m llama2_tpu_torch`` on a v0 checkpoint at
   7B width with 2 layers, written from a seed, as it is and with
   ``--quant int8``, on the ak42 INT8 file converted from it, on the
   param-cache directory that ``--save-cache`` writes from that, and on the
   INT8 file with ``--kv-cache int8`` with and without ``--spec 4``, each
   against ``Generator.generate`` in this process; and the HTTP server
   (``python -m llama2_tpu_torch.runtime.server ... --quant int8 --paged``)
   as a subprocess, its greedy answers equal to an in-process paged engine's
   with its settings and held to ``Generator.generate`` by the margin rule
   (``hold_server_streams``);
5. kernel timing at the main paths' shapes with CUDA events, the calls
   queued behind a device sleep so that the host's launch rate does not set
   the time, beside the bound, the plain version and a library yardstick
   timed here only (the port never calls it):
   ``scaled_dot_product_attention`` for attention, ``torch.matmul`` on the
   pre-dequantized weight for the dequant-matmuls. No one PyTorch call
   computes an FFN megakernel, an int8-cache attention, the whole layer or
   a paged attention: their lines give the route each replaces (the
   composed route; SDPA on a bf16 cache of the same length; K9 + K12; the
   dense twin kernel and SDPA on the same rows gathered) instead. K2 and K4
   stand in the kernels line at pos 256 and at pos 4095; K12 and K11 at 1
   and at the served tick's 8 rows, K13 at 1 and 8 rows. K3, K14,
   K19 and K20 at the kernel benchmarks' shapes, on its inputs (rotated
   through 512 MB), beside SDPA, SDPA on the gathered rows, ``F.rms_norm``
   and ``F.silu(h1) * h3``;
6. the kernel benchmarks' entry point, this slice's path:
   ``python -m llama2_tpu_torch.benchmarks.kernels all`` as a subprocess,
   every expected line present, none over 105% of the card's memory rate or
   peak, every kernel it runs launched (its own counts, from 0).

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. ``python3 chip_smoke.py --dense-timing``
builds the kernels and times only the dense decode attention kernels,
``--prefill-timing`` only the prefill segment's K1, K5 and K6,
``--decode-timing`` only single-stream decode on the two-launch route at
positions 201-264, with K4's host time a call, ``--tick-timing`` only
the served decode tick's kernels (K10-K13 at 8 rows, K15-K18),
``--serve-timing`` only the served bf16-pool path (a timed serving and the
tick profiles), ``--q8kv-timing`` only the int8-cache decode step's
kernels (K7-K9 and K13 at 1 and 8 rows, beside the K9 + K12 pair, and a
split-count sweep), and ``--read-timing`` only the read-only decode
attention kernels (K3, K14, their split sweeps, and K2/K4/K15/K17 at pos
4095) (to compare two checkouts in one call, see
``phase_dense_timing``, ``phase_prefill_timing``, ``phase_decode_timing``,
``phase_tick_timing``, ``phase_serve_timing``, ``phase_q8kv_timing`` and
``phase_read_timing``). Without a CUDA device, or outside a checkout
of the repository, it fails before printing any result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

# the port itself: absent outside a checkout of the repository
from llama2_tpu_torch.benchmarks.kernels import rope_tables
from llama2_tpu_torch.benchmarks.timing import sleep_cycles_per_ms, time_ms

REPO = os.path.dirname(os.path.abspath(__file__))
TOKENIZER_BIN = os.path.join(REPO, "tests", "fixtures", "tokenizer.bin")
SEED = 1234
S = 4096  # Llama-2-7B seq_len; the kernel checks use it for every layout
LAYOUTS = {  # name: (H, KVH, hs)
    "7B": (32, 32, 128),
    "GQA": (32, 4, 64),
    "stories15M": (6, 6, 48),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# dense peaks of an H100 SXM: float32 FMA outside the tensor cores, and the
# tensor cores' TF32 and bf16 rates
PEAK_FLOPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}
# Float32-accurate work needs at least three passes of the tensor cores: two
# float32 operands as TF32 hi + lo pairs (hi hi + hi lo + lo hi), or an int8
# weight (exact in bf16) against x in three bf16 planes. Its least time is
# that of three passes at the narrower type's peak: K1 in fp32 on "tf32",
# the accurate dequant-matmul on "bf16".
ACCURATE_PASSES = 3


def accurate_ops_ms(flops: float, pass_type: str) -> float:
    """The least ms of ``flops`` float32-accurate operations on the tensor
    cores: ACCURATE_PASSES passes at PEAK_FLOPS[pass_type]."""
    return ACCURATE_PASSES * flops / PEAK_FLOPS[pass_type] * 1e3
GROUP = 64  # INT8 quant group size (llama2.c runq default)
# the dequant-matmul shapes of a Llama-2-7B layer and classifier: (K, N)
Q8_SHAPES = {
    "wqkv": (4096, 12288), "wo": (4096, 4096), "w13": (4096, 22016),
    "w2": (11008, 4096), "wcls": (4096, 32000), "w1": (4096, 11008),
}
# the FFN megakernels' ragged check shapes: (D, HD, Dq, G, scale factor). HD =
# 1376 = 172 * 8 and D = 2176 = 17 * 128 divide over no power-of-two tile; the
# group of 8 keeps the FMA form at every row count, the group of 32 takes the
# tensor-core form over a last column strip of 96.
MLP_RAGGED = ((256, 1376, 384, 8, 2.0), (2176, 256, 2304, 64, 2.0), (256, 1376, 384, 32, 2.0))
PROMPT_TOKENS = 200
GEN_TOKENS = 64


def warm_cycles_per_ms() -> float:
    """``sleep_cycles_per_ms`` on a card brought to its working clock first
    (half a second of device sleep), the largest of three readings: a
    reading at an idle clock makes the sleeps that hold the timed calls
    (``time_ms``) too short, and the calls then run as the host issues
    them."""
    import torch

    torch.cuda._sleep(int(1e9))
    torch.cuda.synchronize()
    cycles = max(sleep_cycles_per_ms() for _ in range(3))
    say("time", sleep_cycles_per_ms=f"{cycles:.0f}")
    return cycles


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def dtype_name(dtype) -> str:
    import torch

    return {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]


def tolerance(dtype) -> tuple[float, float]:
    """(rtol, atol) of a kernel against its plain version. fp32: the JAX
    kernel tests' 2e-5 (only the summation order differs). bf16: both sides
    compute in f32 and round once to bf16, so one flip of the last bit is
    allowed, at most 2^-7 of |want|; the atol of 1e-3 covers outputs near 0
    and is a few times smaller than a typical output at 4096 keys."""
    import torch

    return (2e-5, 2e-5) if dtype == torch.float32 else (2**-7, 1e-3)


def q8_tolerance(dtype, mode: str, norm: bool) -> tuple[float, float]:
    """(rtol, atol) of a dequant-matmul kernel against its plain version.
    fp32 outputs: 4e-5, the float32 rounding of sums over K = 4096 and 11008
    taken in another order (largest seen 2.2e-5, on outputs up to 7). Fast
    mode with the rmsnorm prologue: a last-bit difference between the two
    normed rows can flip the bf16 rounding of one x, which moves one product
    by 2^-8 |x| |w| (up to 7e-4 at |x| = 4 and the largest weight here): 1e-3.
    bf16 outputs: one flip of the last bit, as for the attention kernels; in
    fast mode with the prologue that comes on top of the float32 results'
    1e-3, which shows at outputs near 0: atol 2e-3."""
    import torch

    fast_norm = norm and mode == "fast"
    if dtype != torch.float32:
        rtol, atol = tolerance(dtype)
        return (rtol, 2 * atol) if fast_norm else (rtol, atol)
    return (1e-3, 1e-3) if fast_norm else (4e-5, 4e-5)


def mlp_tolerance(dtype, want) -> tuple[float, float]:
    """(rtol, atol) of an FFN megakernel (K10-K12) against its plain version.
    The two sum in another order, so their float32 intermediates differ in the
    last bits, and every operand of the next matmul is rounded to bf16: a
    value that sits on a rounding boundary goes the other way (a step of
    2^-8 |x|, times a weight). At HD = 11008 that happens to a few swiglu
    products a row in every call; the largest single step seen is one bf16
    ulp of a value in [8, 16) times the largest weight, 2^-4 * 0.0446 = 2.8e-3,
    and a row of ``out`` shifted so flips hundreds of roundings of the next
    norm (qkv': 8.2e-3 seen at |qkv'| <= 6). Cases with no such flip agree to
    4e-6. So the bound is relative to the output's scale, 2e-3 of max |want|,
    where a dropped quant group would show as ~1e-1 of it. bf16 outputs add
    one flip of the last bit, as for the other kernels."""
    import torch

    atol = 2e-3 * float(want.float().abs().max())
    return (2e-5, atol) if dtype == torch.float32 else (2**-7, atol)


def compare(got, want, dtype, tol=None) -> float:
    """Max abs error of ``got`` against ``want``; raises past tolerance."""
    import torch

    rtol, atol = tol or tolerance(dtype)
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("kernel output has non-finite values")
    err = (g - w).abs()
    if not bool((err <= atol + rtol * w.abs()).all()):
        if isinstance(atol, torch.Tensor):  # an elementwise bound
            atol = f"{float(atol.min()):.3e}..{float(atol.max()):.3e}"
        raise AssertionError(
            f"max abs err {float(err.max()):.3e} past rtol={rtol} atol={atol}"
        )
    return float(err.max())


# ---------------------------------------------------------------- phase 1


def phase_build() -> None:
    from llama2_tpu_torch.ops.cuda import SOURCES, build

    t0 = time.perf_counter()
    logs = build.build_all(list(SOURCES))
    say("build", sources=",".join(SOURCES), seconds=f"{time.perf_counter() - t0:.1f}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("ptxas", source=name, info=line.strip().replace(" ", "_"))


# ---------------------------------------------------------------- phase 2


# K2 and K4's split form at the head layouts, at a head size that no 16-byte
# vector divides, and with every operand one element past a 16-byte boundary:
# the last two take its one-element-a-lane loop. name: (H, KVH, hs, offset)
SPLIT_CASES = {
    **{name: (*layout, False) for name, layout in LAYOUTS.items()},
    "hs46": (8, 2, 46, False),
    "7B-offset": (32, 32, 128, True),
}


def offset_view(t):
    """``t``'s values in a contiguous tensor whose data starts one element
    past its allocation's (16-byte aligned) start."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def split_vec(case: str, B: int, dtype, rows) -> int:
    """The elements a load in the plan the wrappers take for ``rows`` (the
    cache and new-row operands) at SPLIT_CASES[case]: 16 bytes' worth, or 1
    where the case says the vectors do not fit."""
    import torch

    from llama2_tpu_torch.ops.cuda.attention import plan

    H, KVH, hs, offset = SPLIT_CASES[case]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    vec = plan(B, H, KVH, S, hs, dtype, sms, all(t.data_ptr() % 16 == 0 for t in rows))["vec"]
    v = 16 // dtype.itemsize
    if vec != (1 if offset or hs % v else v):
        raise AssertionError(f"{case}: the plan loads {vec} elements a lane")
    return vec


def split_positions(H: int, KVH: int, hs: int, dtype) -> list[list[int]]:
    """The positions K2 and K4's split form is checked at: 0, 1, the last
    that the batch-1 plan's split count exceeds, either side of 256, 1000,
    the cache's last row, and per-row at 3 and 8 rows."""
    import torch

    from llama2_tpu_torch.ops.cuda.attention import plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = plan(1, H, KVH, S, hs, dtype, sms)["splits"]
    return [[0], [1], [splits - 1], [255], [256], [1000], [S - 1], [0, 5, S - 1], BATCH8_POS]


def split_rerun_checks(tag: str, got, again, pos_list) -> None:
    """A rerun of the split form on the same inputs gives the same bits, and
    every ticket of the workspace is zero after the launches."""
    import torch

    from llama2_tpu_torch.ops.cuda import build

    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{tag} gave different bits on the same inputs at pos={pos_list}")
    tickets = build.workspace(torch.device("cuda"), 0)[1]
    if int(tickets.count_nonzero()) != 0:
        raise AssertionError(f"{tag} left a ticket nonzero at pos={pos_list}")


# K1's checks: LAYOUTS and a head size (44) no tensor-core variant takes
K1_LAYOUTS = {**LAYOUTS, "hs44": (8, 4, 44)}


def k1_variant(dtype, hs: int) -> str:
    """The K1 variant a head size takes: bf16 with hs % 16 == 0 the bf16
    tensor-core one, fp32 with hs % 8 == 0 the TF32 one, else FMA."""
    import torch

    if dtype == torch.bfloat16:
        return "mma" if hs % 16 == 0 else "fma"
    return "tf32" if hs % 8 == 0 else "fma"


def phase_kernels() -> None:
    import torch

    from llama2_tpu_torch.ops.cuda.attention import (
        flash_decode_attention_stacked,
        flash_decode_attention_stacked_plain,
    )
    from llama2_tpu_torch.ops.cuda.prefill_attention import (
        flash_prefill_attention,
        flash_prefill_attention_plain,
        plan,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = tolerance(dtype)
        for lname, (H, KVH, hs) in K1_LAYOUTS.items():
            k = randn(1, KVH, S, hs, dtype=dtype)
            v = randn(1, KVH, S, hs, dtype=dtype)
            # the tensor-core variants take every head size of LAYOUTS (bf16:
            # mma, fp32: tf32); head size 44 is left to the FMA one. Counted apart
            variant = "launches_" + k1_variant(dtype, hs)
            segments = [(T, pos0) for T in (2, 7, 128, 300) for pos0 in (0, 13, 1000)]
            if dtype == torch.float32:  # a verify window at the end of the cache
                segments.append((5, S - 5))
            for T, pos0 in segments:
                q = randn(1, T, H, hs, dtype=dtype)
                n_var = getattr(flash_prefill_attention, variant)
                got = flash_prefill_attention(q, k, v, pos0)
                if getattr(flash_prefill_attention, variant) != n_var + 1:
                    raise AssertionError(f"K1 {dtype_name(dtype)} hs {hs} did not launch its {variant[9:]} variant")
                want = flash_prefill_attention_plain(q, k, v, pos0)
                torch.cuda.synchronize()
                err = compare(got, want, dtype)
                again = flash_prefill_attention(q, k, v, pos0)
                # tf32 segments of few rows cut their keys over blocks: equal
                # bits on rerun, every ticket zero after
                split_rerun_checks(f"K1 {dtype_name(dtype)} {lname} T={T}", got, again, [pos0])
                say("K1", dtype=dtype_name(dtype), layout=lname, T=T, pos0=pos0,
                    variant=variant[9:], splits=plan(1, T, H, KVH, hs, dtype)["splits"],
                    max_abs_err=f"{err:.3e}", rtol=rtol, atol=atol, rerun="equal_bits",
                    tickets="zero")
            del k, v
        for case, (H, KVH, hs, offset) in SPLIT_CASES.items():
            at = offset_view if offset else (lambda t: t)
            L = 2
            for pos_list in split_positions(H, KVH, hs, dtype):
                B = len(pos_list)
                kc = at(randn(L, B, KVH, S, hs, dtype=dtype))
                vc = at(randn(L, B, KVH, S, hs, dtype=dtype))
                q = randn(B, 1, H, hs, dtype=dtype)
                k_new = at(randn(B, KVH, 1, hs, dtype=dtype))
                v_new = at(randn(B, KVH, 1, hs, dtype=dtype))
                vec = split_vec(case, B, dtype, (kc, vc, k_new, v_new))
                pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
                layer = 1
                k_want, v_want = kc.clone(), vc.clone()
                k_plain, v_plain = kc.clone(), vc.clone()
                k_again, v_again = at(kc.clone()), at(vc.clone())
                got = flash_decode_attention_stacked(q, kc, vc, k_new, v_new, layer, pos)
                want = flash_decode_attention_stacked_plain(
                    q, k_plain, v_plain, k_new, v_new, layer, pos
                )
                torch.cuda.synchronize()
                err = compare(got, want, dtype)
                for b, p in enumerate(pos_list):
                    k_want[layer, b, :, p] = k_new[b, :, 0]
                    v_want[layer, b, :, p] = v_new[b, :, 0]
                # only the rows [layer, b, :, pos_b] changed, to the new rows
                if not (torch.equal(kc, k_want) and torch.equal(vc, v_want)):
                    raise AssertionError(f"K2 cache append wrong at {case} pos={pos_list}")
                again = flash_decode_attention_stacked(q, k_again, v_again, k_new, v_new, layer, pos)
                split_rerun_checks(f"K2 {case}", got, again, pos_list)
                say("K2", dtype=dtype_name(dtype), layout=case, B=B,
                    pos=",".join(map(str, pos_list)), vec=vec, max_abs_err=f"{err:.3e}",
                    rtol=rtol, atol=atol, append="exact", rerun="equal_bits", tickets="zero")
                del kc, vc, k_want, v_want, k_plain, v_plain, k_again, v_again


def all_layouts(params: dict) -> dict:
    """The unfused tree together with its ``wqkv`` and ``w13`` fusions."""
    from llama2_tpu_torch.models.llama import fuse_layer_params

    return {**params, **fuse_layer_params(params, "torch")}


def phase_kernels_q8() -> None:
    """K4 against its plain version at SPLIT_CASES; K5/K6 against
    theirs at the five 7B shapes, M = 1, 8 and 201, both modes, fp32 and bf16
    activations, with and without prologue and epilogue, on layers 0 and 31
    of 32-layer stacks."""
    import torch

    from llama2_tpu_torch.io.convert import random_q8_params
    from llama2_tpu_torch.ops.cuda.attention import (
        flash_decode_attention_fused,
        flash_decode_attention_fused_plain,
    )
    from llama2_tpu_torch.ops.cuda.quant_matmul import (
        quant_matmul,
        quant_matmul_plain,
        quant_matmul_stacked,
        quant_matmul_stacked_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = tolerance(dtype)
        for case, (H, KVH, hs, offset) in SPLIT_CASES.items():
            at = offset_view if offset else (lambda t: t)
            L, layer = 2, 1
            for pos_list in split_positions(H, KVH, hs, dtype):
                B = len(pos_list)
                kc = at(randn(L, B, KVH, S, hs, dtype=dtype))
                vc = at(randn(L, B, KVH, S, hs, dtype=dtype))
                k_plain, v_plain = kc.clone(), vc.clone()
                k_again, v_again = at(kc.clone()), at(vc.clone())
                qkv = at(randn(B, H + 2 * KVH, hs, dtype=dtype))
                vec = split_vec(case, B, dtype, (kc, vc, qkv))
                pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
                cos_il, sin_il = rope_tables(pos, hs)
                got = flash_decode_attention_fused(qkv, kc, vc, cos_il, sin_il, layer, pos, n_heads=H)
                want = flash_decode_attention_fused_plain(
                    qkv, k_plain, v_plain, cos_il, sin_il, layer, pos, H
                )
                torch.cuda.synchronize()
                err = compare(got, want, dtype)
                # the rotated K rows and raw V rows, bit for bit, and nothing else
                if not (torch.equal(kc, k_plain) and torch.equal(vc, v_plain)):
                    raise AssertionError(f"K4 cache append wrong at {case} pos={pos_list}")
                again = flash_decode_attention_fused(
                    qkv, k_again, v_again, cos_il, sin_il, layer, pos, n_heads=H
                )
                split_rerun_checks(f"K4 {case}", got, again, pos_list)
                say("K4", dtype=dtype_name(dtype), layout=case, B=B,
                    pos=",".join(map(str, pos_list)), vec=vec, max_abs_err=f"{err:.3e}",
                    rtol=rtol, atol=atol, append="exact", rerun="equal_bits", tickets="zero")
                del kc, vc, k_plain, v_plain, k_again, v_again

    params = all_layouts(random_q8_params(config_7b(), SEED + 4, "cuda", group_size=GROUP))
    combos = ((0, False, False), (31, True, False), (31, False, True), (0, True, True))
    m_rows = (1, 8, 9, 201)  # decode rows, and the M > 8 tile just past them and at the chunk
    for dtype in (torch.float32, torch.bfloat16):
        for mode in ("accurate", "fast"):
            for name, (K, N) in Q8_SHAPES.items():
                worst = {}
                fn = quant_matmul if name == "wcls" else quant_matmul_stacked
                for M in m_rows:
                    x = randn(M, K, dtype=dtype)
                    rms_w = 1 + 0.1 * randn(K, dtype=dtype)
                    res = randn(M, N, dtype=dtype)
                    for layer, norm, resid in combos[:1] if name == "wcls" else combos:
                        kw = dict(mode=mode, rms_w=rms_w if norm else None,
                                  residual=res if resid else None)
                        tiles = getattr(fn, f"launches_tile_{mode}")
                        if name == "wcls":
                            got = quant_matmul(x, params[name], mode=mode)
                            want = quant_matmul_plain(x, params[name], mode=mode)
                        else:
                            got = quant_matmul_stacked(x, params[name], layer, **kw)
                            want = quant_matmul_stacked_plain(x, params[name], layer, **kw)
                        if getattr(fn, f"launches_tile_{mode}") != tiles + (M > 8):
                            raise AssertionError(f"{name} {mode} M={M}: the M > 8 tile count moved wrongly")
                        torch.cuda.synchronize()
                        err = compare(got, want, dtype, q8_tolerance(dtype, mode, norm))
                        worst[M] = max(worst.get(M, 0.0), err)
                say("K5" if name == "wcls" else "K6", dtype=dtype_name(dtype), mode=mode,
                    weight=name, K=K, N=N,
                    max_abs_err_M1_M8_M9_M201=",".join(f"{worst[M]:.3e}" for M in m_rows),
                    tol_plain_and_fast_prologue=f"{q8_tolerance(dtype, mode, False)},"
                    f"{q8_tolerance(dtype, mode, True)}".replace(" ", ""))
    # no float atomics: the same launch gives the same bits, at a decode row
    # and at the prefill chunk (the wgmma tile splits K over blocks at N =
    # 4096), in both modes, from bf16 and fp32 rows (three planes)
    for M in (1, PROMPT_TOKENS + 1):
        for mode, dtype in (("fast", torch.bfloat16), ("accurate", torch.bfloat16), ("accurate", torch.float32)):
            x = randn(M, 4096, dtype=dtype)
            rms_w = 1 + 0.1 * randn(4096, dtype=dtype)
            for w, kw in ((params["wo"], {}), (params["wqkv"], {"rms_w": rms_w})):
                a = quant_matmul_stacked(x, w, 5, mode=mode, **kw)
                for _ in range(3):
                    if not torch.equal(a, quant_matmul_stacked(x, w, 5, mode=mode, **kw)):
                        raise AssertionError(f"K6 {mode} gave different bits on the same inputs (M={M})")
    del params
    torch.cuda.empty_cache()


def phase_kernels_mlp() -> None:
    """K10, K11, K12 against their plain versions: the 7B widths and the two
    ragged shapes; 1, 2, 3, 4, 5, 8 and 12 rows; fp32 and bf16 activations;
    layers 0, L-2 and L-1 of a stack (K12 reads the next layer's norm and QKV
    weights, clamped at the last); K10 with and without the residual. Every
    call is one launch in the form ``mlp_block.variant`` names (the
    tensor-core form for 3 or more rows at group 64; 12 rows a pass of 8,
    then 4; the first ragged shape's group of 8 keeps the FMA form), and a
    second run of each gives the same bits."""
    import torch

    from llama2_tpu_torch.ops.cuda import mlp_block as mb
    from llama2_tpu_torch.quant.q8 import QuantTensor

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def qt(L, K, N, G, factor):
        q = torch.randint(-127, 128, (L, K, N), generator=gen, device="cuda", dtype=torch.int8)
        jitter = torch.rand((L, K // G, N), generator=gen, device="cuda")
        return QuantTensor(q, factor * 2.7e-4 * (0.7 + 0.6 * jitter), G)

    form = ["fma"]  # the form this shape and row count take

    def once(wrapper, *args, **kw):
        """Two runs of one call: one launch each, in the expected form, equal bits."""
        n0, f0 = wrapper.launches, getattr(wrapper, f"launches_{form[0]}")
        a, b = wrapper(*args, **kw), wrapper(*args, **kw)
        if wrapper.launches != n0 + 2 or getattr(wrapper, f"launches_{form[0]}") != f0 + 2:
            raise AssertionError(f"{wrapper.__name__}: {wrapper.launches - n0} launches for 2 calls, "
                                 f"want 2 in the {form[0]} form")
        for u, v in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            if not torch.equal(u, v):
                raise AssertionError(f"{wrapper.__name__} gave different bits on the same inputs")
        return a

    L = 4
    shapes = ((4096, 11008, 12288, GROUP, 1.0),) + MLP_RAGGED
    for D, HD, Dq, G, factor in shapes:
        wo, w1, w3 = qt(L, D, D, G, factor), qt(L, D, HD, G, factor), qt(L, D, HD, G, factor)
        w2, wqkv = qt(L, HD, D, G, factor), qt(L, D, Dq, G, factor)
        for dtype in (torch.float32, torch.bfloat16):
            rms_ffn = 1 + 0.1 * randn(L, D, dtype=dtype)
            rms_att = 1 + 0.1 * randn(L, D, dtype=dtype)
            worst = {}

            def hold(name, got, want):
                torch.cuda.synchronize()
                err = compare(got, want, dtype, mlp_tolerance(dtype, want))
                rel = err / float(want.float().abs().max())
                worst[name] = max(worst.get(name, (0.0, 0.0)), (err, rel))

            forms = set()
            for M in (1, 2, 3, 4, 5, 8, 12):
                form[0] = mb.variant(M, D, HD, Dq, (G, G, G, G))
                forms.add(f"M{M}:{form[0]}")
                x, att = randn(M, D, dtype=dtype), randn(M, D, dtype=dtype)
                for layer in (0, L - 2, L - 1):
                    for residual in (True, False):
                        got = once(mb.mlp_block_stacked, x, rms_ffn[layer], w1, w3, w2, layer,
                                   residual=residual)
                        hold("K10", got, mb.mlp_block_plain(x, rms_ffn[layer], w1, w3, w2, layer,
                                                            residual=residual))
                    got = once(mb.attn_mlp_block_stacked, att, x, wo, rms_ffn[layer], w1, w3, w2, layer)
                    hold("K11", got, mb.attn_mlp_block_plain(att, x, wo, rms_ffn[layer], w1, w3, w2, layer))
                    out, qkv = once(mb.layer_tail_qkv_stacked, att, x, wo, rms_ffn, w1, w3, w2,
                                    rms_att, wqkv, layer)
                    want = mb.layer_tail_qkv_plain(att, x, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, layer)
                    hold("K12", out, want[0])
                    hold("K12qkv", qkv, want[1])
            say("K10-K12", dtype=dtype_name(dtype), D=D, HD=HD, Dq=Dq, G=G, forms=",".join(sorted(forms)),
                layers=f"0,{L - 2},{L - 1}", bits="equal_on_rerun",
                tol="rtol=%g,atol=2e-3*max|want|" % mlp_tolerance(dtype, x)[0],
                **{f"{k}_max_abs_err": f"{e:.3e}" for k, (e, _) in worst.items()},
                **{f"{k}_err_over_max": f"{r:.2e}" for k, (_, r) in worst.items()})
        del wo, w1, w3, w2, wqkv
    for mt in (1, 2, 4, 8):
        say("K10-K12", rows_a_thread=mt, cooperative_grid_blocks=mb._grid(mt, torch.cuda.current_device()))
    say("K10-K12", form="mma", cooperative_grid_blocks=mb._grid(8, torch.cuda.current_device(), False, True))
    # a CUDA tensor launches or raises: no plain version behind the wrapper
    w1, w3, w2 = qt(2, 256, 384, 64, 1.0), qt(2, 256, 384, 64, 1.0), qt(2, 384, 256, 64, 1.0)
    x = randn(1, 256, dtype=torch.float32)
    n0 = mb.mlp_block_stacked.launches
    for bad in ((x, randn(256, dtype=torch.float32), w1, w3[:1], w2, 0),  # layer counts differ
                (x.double(), randn(256, dtype=torch.float64), w1, w3, w2, 0)):  # an unported dtype
        try:
            mb.mlp_block_stacked(*bad)
        except ValueError:
            continue
        raise AssertionError("K10 accepted operands its kernel does not take")
    if mb.mlp_block_stacked.launches != n0:
        raise AssertionError("a refused K10 call counted a launch")
    torch.cuda.empty_cache()


def q8kv_terms(q4, k8, ks, v8, vs, horizon, weight=None):
    """The int8-cache attention of the plain versions (``attention_q8.py``'s
    ``_attend_plain``) of q4 (B, T, H, hs) over one layer's cache (B, KVH, S,
    hs) int8 + (B, KVH, S) float32, row t of batch b seeing keys 0..horizon[b,
    t]; with ``weight`` (S,), each key's p is multiplied by it (a planted
    fault: 0 drops keys, 2 doubles a split's share in the merge). Returns
    float32 (out, A, R), each (B, T, H, hs): A = sum_t w_t |v_t| and R =
    sqrt(sum_t w_t^2 v_t^2), w = p / l the softmax weights and v the
    dequantized values, element by element."""
    import torch

    B, T, H, hs = q4.shape
    KVH = k8.shape[1]
    n = int(horizon.max()) + 1
    qb = q4.to(torch.bfloat16).float().reshape(B, T, KVH, H // KVH, hs)
    s = torch.einsum("btkgd,bksd->bkgts", qb, k8[:, :, :n].float())
    s = s * (ks[:, :, None, None, :n] * (1.0 / hs**0.5))
    visible = torch.arange(n, device=q4.device)[None, None, :] <= horizon[:, :, None]
    s = s.masked_fill(~visible[:, None, None], float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if weight is not None:
        p = p * weight[:n]
    l = p.sum(dim=-1, keepdim=True)
    pv = (p * vs[:, :, None, None, :n]).to(torch.bfloat16).float()
    v = v8[:, :, :n].float()
    out = torch.einsum("bkgts,bksd->bkgtd", pv, v) / l
    w, vd = p / l, v * vs[:, :, :n, None]
    A = torch.einsum("bkgts,bksd->bkgtd", w, vd.abs())
    R = torch.einsum("bkgts,bksd->bkgtd", w * w, vd * vd).sqrt()
    return tuple(t.permute(0, 3, 1, 2, 4).reshape(B, T, H, hs) for t in (out, A, R))


def q8kv_tolerance(dtype, A, R, rtol=None):
    """(rtol, elementwise atol) of an int8-cache attention kernel (K7-K9, and
    K13's attention phase) against its plain version, from ``q8kv_terms``'
    A and R of the same inputs. Both round each term ``p * v_scale`` to bf16,
    but p is taken against the running maximum in the kernel and against the
    row's maximum in the plain version, so the two roundings of a term differ
    by at most 2^-7 of it: 2^-7 A in all. Over many keys those differences
    are independent and of mean 0, and Hoeffding's bound puts their sum past
    2^-4 R with probability under 1e-13; the atol is the smaller of the two,
    plus 2^-16 A for the float32 steps. At pos 4095 with N(0, 1) scores it is
    about 1.6e-3, where dropping one 32-key chunk moves outputs by 2e-3 (one
    sigma; ``planted_faults_fail`` holds every check to that). fp32 outputs:
    rtol 2e-5 on top; bf16 outputs one flip of the last bit, as for the other
    kernels."""
    import torch

    atol = torch.minimum(2**-7 * A, 2**-4 * R) + 2**-16 * A
    if rtol is None:
        rtol = 2e-5 if dtype == torch.float32 else 2**-7
    return rtol, atol


# faults planted in the plain computation at pos 4095: keys (first, end) and
# the factor on their p. 256 keys are one split of the 7B layout at batch 1
# (17 splits over 4096 keys, 8 chunks each); a chunk is the kernel's 32 keys.
PLANTED = {"chunk_dropped": (2048, 2080, 0.0), "split_dropped": (1024, 1280, 0.0),
           "split_weighted_2x": (1024, 1280, 2.0)}


def planted_faults_fail(want, dtype, tol, terms_args, shape_out, what: str) -> None:
    """Each fault of PLANTED, computed by ``q8kv_terms(*terms_args, weight)``
    and shaped by ``shape_out`` like the kernel's output, must fail the
    comparison with ``want`` at tolerance ``tol``; the same computation
    without a fault must pass it."""
    import torch

    compare(shape_out(q8kv_terms(*terms_args)[0]), want, dtype, tol)
    for name, (a, b, factor) in PLANTED.items():
        weight = torch.ones(S, device=want.device)
        weight[a:b] = factor
        bad = shape_out(q8kv_terms(*terms_args, weight=weight)[0])
        try:
            compare(bad, want, dtype, tol)
        except AssertionError:
            continue
        raise AssertionError(f"{what}: the tolerance passes a planted fault ({name})")


# K13's atol, of max |want| (bf16 outputs add rtol 2^-7, one flip of the last
# bit): against its plain version, where bf16(p * v_scale) may round the other
# way (K7-K9's tolerance) and that flips bf16 roundings of the rows after;
# and against K9 + K12, as tests/test_layer_block.py holds the Pallas kernel
K13_PLAIN_TOL = 1e-2
K13_K9K12_TOL = 2e-2


def k13_grids(D: int, HD: int) -> dict:
    """K13's cooperative grid and its attention phase's items at 1 and 8
    rows, at the 7B widths (``layer_block.launch_plans``)."""
    import torch

    from llama2_tpu_torch.ops.cuda import layer_block as lb

    (H, KVH, hs), dev, out = LAYOUTS["7B"], torch.cuda.current_device(), {}
    for M in (1, 8):
        p, q = lb.launch_plans(M, D, HD, (H + 2 * KVH) * hs, (GROUP,) * 4, H, KVH, S, hs, dev)
        out[f"M{M}_grid_blocks"] = p["grid"]
        out[f"M{M}_attention"] = f"{q['grid']}_items,{q['splits']}_splits,unroll_{q['unroll']}"
    return out


def phase_kernels_q8kv() -> None:
    """K7, K8, K9 and K13 against their plain versions on the card.

    K7 (read only): T = 1, 4, 16 query rows, the 7B and a GQA head layout, a
    batch of two rows at their own positions (the first at 0 (T - 1 for a
    window), 127 and 4095). K8 and K9: the 7B and the GQA layout, a 32-layer
    cache, layers 0 and 31, rows at (0, 5) and (127, 4095); the appended
    bytes and scales ``torch.equal`` to the plain version's, and nothing else
    of the cache touched. K13 at the 7B widths: with and without the qkv
    phase, pos 0 (only this step's row), 256 and 4095, fp32 and bf16; against
    its plain version (K13_PLAIN_TOL) and against K9 + K12 (K13_K9K12_TOL; the
    two differ in how this step's row joins), its appends bit-equal to both.
    Every call is one launch, and a second run gives the same bits."""
    import torch

    from llama2_tpu_torch.ops.cuda import attention_q8 as aq
    from llama2_tpu_torch.ops.cuda import layer_block as lb
    from llama2_tpu_torch.ops.cuda import mlp_block as mb
    from llama2_tpu_torch.quant.q8 import QuantTensor

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def cache(*shape):
        k8, ks = aq.quantize_kv_rows(randn(*shape))
        v8, vs = aq.quantize_kv_rows(randn(*shape))
        return [k8, ks, v8, vs]

    def twice(wrapper, *args, **kw):
        """Two runs of one call, each on its own copy of the four cache
        tensors (from the first int8 argument on): one launch each, the same
        bits, the caches left alike. Returns the first run's output and
        caches."""
        n0 = wrapper.launches
        lo = next(i for i, t in enumerate(args) if isinstance(t, torch.Tensor) and t.dtype == torch.int8)
        outs, caches = [], []
        for _ in range(2):
            c = [t.clone() for t in args[lo : lo + 4]]
            outs.append(wrapper(*args[:lo], *c, *args[lo + 4 :], **kw))
            caches.append(c)
        if wrapper.launches != n0 + 2:
            raise AssertionError(f"{wrapper.__name__}: {wrapper.launches - n0} launches for 2 calls")
        o1, o2 = ((outs[0], outs[1]) if isinstance(outs[0], tuple) else ((outs[0],), (outs[1],)))
        if not all(u is None or torch.equal(u, v) for u, v in zip(o1, o2)) or not all(
                torch.equal(u, v) for u, v in zip(*caches)):
            raise AssertionError(f"{wrapper.__name__} gave different bits on the same inputs")
        return outs[0], caches[0]

    def hold(got, want, dtype, terms, shape, what, round_to=None, rtol=None, plant=False):
        """``got`` against ``want`` at ``q8kv_tolerance`` of ``terms`` (the
        arguments of ``q8kv_terms``; ``shape`` takes its (B, T, H, hs) to the
        output's shape); with ``plant``, the planted faults (rounded through
        ``round_to`` as the kernel's output is) must fail it. Returns the
        max abs error and its largest share of the bound."""
        _, A, R = q8kv_terms(*terms)
        rt, atol = q8kv_tolerance(dtype, shape(A), shape(R), rtol)
        err = compare(got, want, dtype, (rt, atol))
        bound = atol + rt * want.float().abs()
        share = float(torch.where(bound > 0, (got.float() - want.float()).abs() / bound, 0.0).max())
        if plant:
            planted_faults_fail(want, dtype, (rt, atol), terms,
                                lambda o: shape(o).to(round_to or dtype).to(dtype), what)
        return err, share

    def worse(a, b):
        return tuple(max(x, y) for x, y in zip(a, b))

    def fmt(worst):
        return f"{worst[0]:.3e}", f"{worst[1]:.3f}"

    for dtype in (torch.float32, torch.bfloat16):
        dn = dtype_name(dtype)
        for lname in ("7B", "GQA"):
            H, KVH, hs = LAYOUTS[lname]
            k8, ks, v8, vs = cache(2, KVH, S, hs)
            worst = (0.0, 0.0)
            for T in (1, 4, 16):
                for p0 in (T - 1, 127, S - 1):
                    pos = torch.tensor([p0, max(T - 1, p0 // 2)], dtype=torch.int32, device="cuda")
                    q = randn(2, T, H, hs, dtype=dtype)
                    n0 = aq.flash_decode_attention_q8.launches
                    got = aq.flash_decode_attention_q8(q, k8, ks, v8, vs, pos)
                    again = aq.flash_decode_attention_q8(q, k8, ks, v8, vs, pos)
                    if aq.flash_decode_attention_q8.launches != n0 + 2 or not torch.equal(got, again):
                        raise AssertionError("K7: not one launch a call, or other bits on a rerun")
                    want = aq.flash_decode_attention_q8_plain(q, k8, ks, v8, vs, pos)
                    torch.cuda.synchronize()
                    horizon = pos.long()[:, None] - (T - 1) + torch.arange(T, device="cuda")[None, :]
                    worst = worse(worst, hold(got, want, dtype, (q, k8, ks, v8, vs, horizon), lambda t: t,
                                              f"K7 {lname} T={T}", plant=p0 == S - 1))
            err, share = fmt(worst)
            say("K7", dtype=dn, layout=lname, T="1,4,16", pos0=f"T-1,127,{S - 1}", max_abs_err=err,
                err_over_bound=share, planted_faults_at_4095="fail", bits="equal_on_rerun")
            del k8, ks, v8, vs
            L = 32
            caches = cache(L, 2, KVH, S, hs)
            for layer in (0, L - 1):
                for pos_list in ([0, 5], [127, S - 1]):
                    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
                    q = randn(2, H, hs, dtype=dtype)
                    rows = aq.quantize_kv_rows(randn(2, KVH, 1, hs))
                    vrows = aq.quantize_kv_rows(randn(2, KVH, 1, hs))
                    news = (rows[0], rows[1], vrows[0], vrows[1])
                    got, c_k = twice(aq.flash_decode_attention_q8_stacked, q, *caches, *news, layer, pos)
                    c_p = [t.clone() for t in caches]
                    want = aq.flash_decode_attention_q8_stacked_plain(q, *c_p, *news, layer, pos)
                    torch.cuda.synchronize()
                    at_layer = [t[layer] for t in c_p]
                    plant = pos_list[-1] == S - 1
                    e8 = hold(got, want, dtype, (q[:, None], *at_layer, pos.long()[:, None]),
                              lambda t: t[:, 0], f"K8 {lname}", plant=plant)
                    if not all(torch.equal(a, b) for a, b in zip(c_k, c_p)):
                        raise AssertionError(f"K8 cache append differs from the plain version at {pos_list}")
                    qkv = randn(2, H + 2 * KVH, hs, dtype=dtype)
                    cos_il, sin_il = rope_tables(pos, hs)
                    got, c_k = twice(aq.flash_decode_attention_q8_fused, qkv, *caches, cos_il, sin_il, layer,
                                     pos, n_heads=H)
                    c_p = [t.clone() for t in caches]
                    want = aq.flash_decode_attention_q8_fused_plain(qkv, *c_p, cos_il, sin_il, layer, pos, H)
                    torch.cuda.synchronize()
                    q_rot = aq.rope_quantize_plain(qkv, cos_il, sin_il, H)[0]
                    e9 = hold(got, want, dtype, (q_rot[:, None], *[t[layer] for t in c_p], pos.long()[:, None]),
                              lambda t: t[:, 0], f"K9 {lname}", plant=plant)
                    if not all(torch.equal(a, b) for a, b in zip(c_k, c_p)):
                        raise AssertionError(f"K9 cache append differs from the plain version at {pos_list}")
                    # nothing but the rows at [layer, b, :, pos_b] changed
                    touched = (caches[0] != c_p[0]).any(-1).nonzero().tolist()  # (layer, b, head, row)
                    if any(t[0] != layer or t[3] != pos_list[t[1]] for t in touched):
                        raise AssertionError(f"K9 wrote outside the appended rows: {touched[:4]}")
                    (e8, s8), (e9, s9) = fmt(e8), fmt(e9)
                    say("K8,K9", dtype=dn, layout=lname, layer=layer, pos=",".join(map(str, pos_list)),
                        K8_max_abs_err=e8, K8_err_over_bound=s8, K9_max_abs_err=e9, K9_err_over_bound=s9,
                        planted_faults_at_4095="fail" if plant else "not_planted",
                        append="equal_to_plain", bits="equal_on_rerun")
            del caches
            torch.cuda.empty_cache()

    # K13 at the 7B widths
    def qt(L, K, N):
        q = torch.randint(-127, 128, (L, K, N), generator=gen, device="cuda", dtype=torch.int8)
        return QuantTensor(q, 2.7e-4 * (0.7 + 0.6 * torch.rand((L, K // GROUP, N), generator=gen, device="cuda")),
                           GROUP)

    (H, KVH, hs), L = LAYOUTS["7B"], 2
    D, HD = H * hs, 11008
    wo, w1, w3, w2, wqkv = qt(L, D, D), qt(L, D, HD), qt(L, D, HD), qt(L, HD, D), qt(L, D, (H + 2 * KVH) * hs)

    class Cfg:
        n_heads, n_kv_heads, head_size = H, KVH, hs

    if not lb.layer_block_supported(wo, w1, w3, w2, wqkv, Cfg):
        raise AssertionError("K13 does not take the 7B widths")
    eye = (64 * torch.eye(D, device="cuda")).to(torch.int8)
    wo_id = QuantTensor(eye.expand(L, D, D).contiguous(), torch.full((L, D // GROUP, D), 2.0**-6, device="cuda"),
                        GROUP)
    w2_0 = QuantTensor(torch.zeros_like(w2.q), w2.scale, GROUP)
    del eye

    def x0(dtype):
        return torch.zeros((1, D), dtype=dtype, device="cuda")

    for dtype in (torch.float32, torch.bfloat16):
        rms_ffn, rms_att = 1 + 0.1 * randn(L, D, dtype=dtype), 1 + 0.1 * randn(L, D, dtype=dtype)
        caches = cache(L, 1, KVH, S, hs)
        worst = {}
        for p in (0, 256, S - 1):
            pos = torch.tensor([p], dtype=torch.int32, device="cuda")
            cos_il, sin_il = rope_tables(pos, hs)
            qkv3, x = randn(1, H + 2 * KVH, hs, dtype=dtype), randn(1, D, dtype=dtype)
            for with_qkv in (True, False):
                layer = 0 if with_qkv else L - 1
                args = (cos_il, sin_il, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, layer, pos)
                got, c_k = twice(lb.layer_block_stacked, qkv3, x, *caches, *args, n_heads=H, with_qkv=with_qkv)
                c_p = [t.clone() for t in caches]
                want = lb.layer_block_stacked_plain(qkv3, x, *c_p, *args, n_heads=H, with_qkv=with_qkv)
                c_9 = [t.clone() for t in caches]
                att = aq.flash_decode_attention_q8_fused(qkv3, *c_9, cos_il, sin_il, layer, pos, n_heads=H)
                if with_qkv:
                    pair = mb.layer_tail_qkv_stacked(att.reshape(1, D), x, wo, rms_ffn, w1, w3, w2, rms_att, wqkv,
                                                     layer)
                else:
                    pair = (mb.attn_mlp_block_stacked(att.reshape(1, D), x, wo, rms_ffn[layer], w1, w3, w2, layer),
                            None)
                torch.cuda.synchronize()
                if not (all(torch.equal(a, b) for a, b in zip(c_k, c_p))
                        and all(torch.equal(a, b) for a, b in zip(c_k, c_9))):
                    raise AssertionError(f"K13 appends differ from the plain version's or K9's at pos {p}")
                for i, tag in enumerate(("out", "qkv")[: 2 if with_qkv else 1]):
                    scale = float(want[i].float().abs().max())
                    rtol = 0.0 if dtype == torch.float32 else 2**-7  # bf16: one flip of the last bit
                    e_p = compare(got[i], want[i], dtype, (rtol, K13_PLAIN_TOL * scale))
                    e_9 = compare(got[i], pair[i], dtype, (rtol, K13_K9K12_TOL * scale))
                    key = f"{tag}_with_qkv" if with_qkv else tag
                    old = worst.get(key, (0.0, 0.0))
                    worst[key] = (max(old[0], e_p / scale), max(old[1], e_9 / scale))
        say("K13", dtype=dtype_name(dtype), D=D, HD=HD, pos=f"0,256,{S - 1}", with_qkv="true,false",
            tol=f"{K13_PLAIN_TOL}*max|want|(plain),{K13_K9K12_TOL}*max|want|(K9+K12),rtol_bf16=2^-7",
            append="equal_to_plain_and_K9", bits="equal_on_rerun",
            **k13_grids(D, HD),
            **{f"{k}_err_over_max_vs_plain": f"{a:.2e}" for k, (a, _) in worst.items()},
            **{f"{k}_err_over_max_vs_K9K12": f"{b:.2e}" for k, (_, b) in worst.items()})
        # the attention phase alone: wo the identity (64 * 2^-6 = 1), w2 zero
        # and x zero give out = bf16(att) exactly, held like K9
        worst = (0.0, 0.0)
        for p in (0, 256, S - 1):
            pos = torch.tensor([p], dtype=torch.int32, device="cuda")
            cos_il, sin_il = rope_tables(pos, hs)
            qkv3 = randn(1, H + 2 * KVH, hs, dtype=dtype)
            for with_qkv in (True, False):
                layer = 0 if with_qkv else L - 1
                args = (cos_il, sin_il, wo_id, rms_ffn, w1, w3, w2_0, rms_att, wqkv, layer, pos)
                got, _ = twice(lb.layer_block_stacked, qkv3, x0(dtype), *caches, *args, n_heads=H,
                               with_qkv=with_qkv)
                c_p = [t.clone() for t in caches]
                want = lb.layer_block_stacked_plain(qkv3, x0(dtype), *c_p, *args, n_heads=H, with_qkv=with_qkv)
                torch.cuda.synchronize()
                q_rot = aq.rope_quantize_plain(qkv3, cos_il, sin_il, H)[0]
                # att is rounded to bf16 in both dtypes: one flip of its last bit
                worst = worse(worst, hold(got[0], want[0], dtype,
                                          (q_rot[:, None], *[t[layer] for t in c_p], pos.long()[:, None]),
                                          lambda t: t.reshape(1, D), "K13 attention phase",
                                          round_to=torch.bfloat16, rtol=2**-7, plant=p == S - 1))
        err, share = fmt(worst)
        say("K13", dtype=dtype_name(dtype), part="attention_phase_alone", pos=f"0,256,{S - 1}",
            with_qkv="true,false", max_abs_err=err, err_over_bound=share, planted_faults_at_4095="fail")
        del caches
    # a CUDA tensor launches or raises: no plain version behind the wrapper
    k8, ks, v8, vs = cache(1, 2, 64, 16)
    n0 = aq.flash_decode_attention_q8.launches
    for bad in (randn(1, 17, 4, 16), randn(1, 1, 4, 16, dtype=torch.float64), randn(1, 1, 3, 16)):
        try:
            aq.flash_decode_attention_q8(bad, k8, ks, v8, vs, 20)
        except ValueError:
            continue
        raise AssertionError("K7 accepted operands its kernel does not take")
    if aq.flash_decode_attention_q8.launches != n0:
        raise AssertionError("a refused K7 call counted a launch")
    del wo, w1, w3, w2, wqkv, wo_id, w2_0
    torch.cuda.empty_cache()


# the paged kernel checks' 8 slots: positions by page size; the last
# N_INACTIVE are inactive (all-zero table rows: the scratch page 0), writing
# rows 5 and 9 of it
N_INACTIVE = 2


def paged_positions(page: int) -> list[int]:
    return [0, page - 1, page, 1000, S - 1, 2 * page + 77, 5, 9]


def paged_table(pos_list, page: int, n_pages: int, gen):
    """A (B, S // page) int32 table for ``pos_list``: each active slot takes
    the pages its position needs from a shuffled order of 1..n_pages - 1 (so
    no slot's pages ascend), the slot at S - 1 including the pool's last
    page (the largest offsets); inactive rows all 0."""
    import torch

    n_active = len(pos_list) - N_INACTIVE
    perm = (torch.randperm(n_pages - 1, generator=gen) + 1).tolist()
    table = torch.zeros((len(pos_list), S // page), dtype=torch.int32)
    at = 0
    for b, p in enumerate(pos_list[:n_active]):
        n = p // page + 1
        table[b, :n] = torch.tensor(perm[at : at + n], dtype=torch.int32)
        at += n
    top = (table == n_pages - 1).nonzero().tolist()
    b4, c4 = pos_list.index(S - 1), (S - 1) // page  # the S - 1 slot's last page
    if top:  # swap the pool's last page there
        (tb, tc), = top
        table[tb, tc], table[b4, c4] = table[b4, c4].item(), n_pages - 1
    else:
        table[b4, c4] = n_pages - 1
    return table


def phase_kernels_paged() -> None:
    """K15-K18 against their plain versions on the card.

    8 slots at paged_positions (0, page - 1, page, 1000, 4095, a mid-page
    row; two inactive slots on the scratch page), pages handed out shuffled,
    pages of 256 and 128 rows, the 7B and a GQA head layout, layers 0 and 31
    of a 32-layer pool; fp32 and bf16 pools (K15, K17) and int8 pools on
    fp32 and bf16 activations (K16, K18). The bf16 and int8 pools of the 7B
    layout with 256-row pages hold 72 pages, so the last layer's offsets pass
    2^31 elements. Each call is one launch; a second run on the same inputs
    gives the same bits (outputs of the active slots, and the pools); the
    appended rows and scales equal the plain version's, and nothing else of
    the pools changes. Outputs of the active slots: the fp kernels to
    ``tolerance``, the int8 ones to ``q8kv_tolerance``, with the planted
    faults failing it at pos 4095; the inactive slots' outputs (a harmless
    race on the scratch page) must be finite."""
    import torch

    from llama2_tpu_torch.ops.cuda import attention_q8 as aq
    from llama2_tpu_torch.ops.cuda import paged_attention as tpa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    cpu_gen = torch.Generator().manual_seed(SEED + 11)
    L, B = 32, 8
    act = B - N_INACTIVE

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def pool(shape, kind):
        """Random pool contents, drawn in place (no float32 copy of a big pool)."""
        if kind == "int8":
            k8 = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
            ks = 0.02 + 0.01 * torch.rand(shape[:-1], generator=gen, device="cuda")
            return [k8, ks]
        t = torch.empty(shape, dtype=torch.float32 if kind == "f32" else torch.bfloat16, device="cuda")
        return [t.normal_(generator=gen)]

    def run(wrapper, plain, pre, pools, post, kw, coords, layer):
        """The kernel twice on copies of ``pools`` (one launch each, the same
        bits), the rows it changed checked against the write coordinates,
        then the plain version on ``pools`` in place: (got, want)."""
        n0 = wrapper.launches
        c1 = [t.clone() for t in pools]
        got = wrapper(*pre, *c1, *post, **kw)[0]
        c2 = [t.clone() for t in pools]
        again = wrapper(*pre, *c2, *post, **kw)[0]
        torch.cuda.synchronize()
        if wrapper.launches != n0 + 2:
            raise AssertionError(f"{wrapper.__name__}: {wrapper.launches - n0} launches for 2 calls")
        if not (torch.equal(got[:act], again[:act]) and all(torch.equal(a, b) for a, b in zip(c1, c2))):
            raise AssertionError(f"{wrapper.__name__} gave different bits on the same inputs")
        del c2
        if not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"{wrapper.__name__}: non-finite outputs (inactive slots included)")
        allowed = {(layer, p, r) for p, r in coords}
        for new, old in zip(c1, pools):
            diff = new != old
            touched = (diff.any(-1) if diff.ndim == 5 else diff).nonzero()[:, [0, 1, 3]].tolist()
            if any(tuple(t) not in allowed for t in touched):
                raise AssertionError(f"{wrapper.__name__} wrote outside the write rows: {touched[:4]}")
            del diff
        want = plain(*pre, *pools, *post, **kw)[0]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(c1, pools)):
            raise AssertionError(f"{wrapper.__name__}: appended rows differ from the plain version's")
        return got, want

    for lname in ("7B", "GQA"):
        H, KVH, hs = LAYOUTS[lname]
        for page in (256, 128):
            pos_list = paged_positions(page)
            pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
            cos_il, sin_il = rope_tables(pos, hs)
            for kind in ("f32", "bf16", "int8"):
                big = lname == "7B" and page == 256 and kind != "f32"
                need = sum(p // page + 1 for p in pos_list[:act]) + 1
                n_pages = 72 if big else need
                table = paged_table(pos_list, page, n_pages, cpu_gen).cuda()
                wpage = table[torch.arange(B, device="cuda"), (pos // page).long()].contiguous()
                wrow = (pos % page).contiguous()
                coords = list(zip(wpage.tolist(), wrow.tolist()))
                shape = (L, n_pages, KVH, page, hs)
                pools = pool(shape, kind) + pool(shape, kind)
                dtypes = (torch.float32, torch.bfloat16) if kind == "int8" else (pools[0].dtype,)
                worst = {}
                for dtype in dtypes:
                    for layer in (0, L - 1):
                        q = randn(B, H, hs, dtype=dtype)
                        qkv = randn(B, H + 2 * KVH, hs, dtype=dtype)
                        args = (table, wpage, wrow, layer, pos)
                        if kind == "int8":
                            k8, ks = aq.quantize_kv_rows(randn(B, KVH, 1, hs))
                            v8, vs = aq.quantize_kv_rows(randn(B, KVH, 1, hs))
                            cases = (
                                ("K16", tpa.paged_decode_attention_q8_stacked,
                                 tpa.paged_decode_attention_q8_stacked_plain, (q,),
                                 (table, k8, ks, v8, vs, wpage, wrow, layer, pos), {}, q),
                                ("K18", tpa.paged_decode_attention_q8_fused,
                                 tpa.paged_decode_attention_q8_fused_plain, (qkv,),
                                 (table, cos_il, sin_il, wpage, wrow, layer, pos), {"n_heads": H},
                                 aq.rope_quantize_plain(qkv, cos_il, sin_il, H)[0]),
                            )
                        else:
                            kn = randn(B, KVH, 1, hs, dtype=dtype)
                            vn = randn(B, KVH, 1, hs, dtype=dtype)
                            cases = (
                                ("K15", tpa.paged_decode_attention_stacked,
                                 tpa.paged_decode_attention_stacked_plain, (q,),
                                 (table, kn, vn, *args[1:]), {}, None),
                                ("K17", tpa.paged_decode_attention_fused,
                                 tpa.paged_decode_attention_fused_plain, (qkv,),
                                 (table, cos_il, sin_il, *args[1:]), {"n_heads": H}, None),
                            )
                        for tag, wrapper, plain, pre, post, kw, q_terms in cases:
                            c = [t.clone() for t in pools]
                            got, want = run(wrapper, plain, pre, c, post, kw, coords, layer)
                            if kind == "int8":
                                n = (S - 1) // page + 1
                                dense = [tpa.gather_pages(t[layer], table, n)[:act] for t in c]
                                terms = (q_terms[:act, None], *dense, pos.long()[:act, None])
                                _, A, R = q8kv_terms(*terms)
                                tol = q8kv_tolerance(dtype, A[:, 0], R[:, 0])
                                err = compare(got[:act], want[:act], dtype, tol)
                                bound = tol[1] + tol[0] * want[:act].float().abs()
                                share = float(((got[:act].float() - want[:act].float()).abs() / bound).max())
                                planted_faults_fail(want[:act], dtype, tol, terms,
                                                    lambda o: o[:, 0].to(dtype), f"{tag} {lname}")
                            else:
                                err = compare(got[:act], want[:act], dtype)
                                share = 0.0
                            del c
                            old = worst.get((tag, dtype), (0.0, 0.0))
                            worst[(tag, dtype)] = (max(old[0], err), max(old[1], share))
                for (tag, dtype), (err, share) in worst.items():
                    say(tag, dtype=dtype_name(dtype), pool=kind, layout=lname, page=page,
                        pool_pages=n_pages, layers="0,31", pos=",".join(map(str, pos_list)),
                        inactive=N_INACTIVE, max_abs_err=f"{err:.3e}",
                        **({"err_over_bound": f"{share:.3f}", "planted_faults_at_4095": "fail"}
                           if kind == "int8" else {}),
                        append="equal_to_plain", bits="equal_on_rerun")
                del pools
                torch.cuda.empty_cache()
    paged_split_checks(randn)
    # a CUDA tensor launches or raises: operands the kernels do not take
    z = torch.zeros
    pools = [z(1, 3, 2, 16, 33, device="cuda"), z(1, 3, 2, 16, 33, device="cuda")]
    ti = z(2, 2, dtype=torch.int32, device="cuda")
    ci = z(2, dtype=torch.int32, device="cuda")
    n0 = tpa.paged_decode_attention_fused.launches
    for bad in ((z(2, 8, 33, device="cuda"), *pools),  # odd head size
                (z(2, 8, 32, device="cuda", dtype=torch.float64), pools[0][..., :32], pools[1][..., :32])):
        try:
            tpa.paged_decode_attention_fused(*bad, ti, z(2, bad[0].shape[-1], device="cuda"),
                                             z(2, bad[0].shape[-1], device="cuda"), ci, ci, 0, ci,
                                             n_heads=4)
        except ValueError:
            continue
        raise AssertionError("K17 accepted operands its kernel does not take")
    if tpa.paged_decode_attention_fused.launches != n0:
        raise AssertionError("a refused K17 call counted a launch")


def paged_split_checks(randn) -> None:
    """K15 and K17 on the split form at K2/K4's checks (SPLIT_CASES at
    split_positions: the one-element-a-lane loop at head size 46 and one
    element off 16-byte alignment), every slot active, its pages (256 rows)
    handed out shuffled, the table's reach S; at 8 slots also at 3 splits
    (split edges inside pages) through ``_fp_launch``'s ``splits``. Against
    the plain versions at ``tolerance``; the appended rows equal to the plain
    version's, a rerun bit-equal, every ticket zero after."""
    import torch

    from llama2_tpu_torch.ops.cuda import paged_attention as tpa

    gen = torch.Generator().manual_seed(SEED + 12)
    L, layer, page = 2, 1, 256
    for dtype in (torch.float32, torch.bfloat16):
        for case, (H, KVH, hs, offset) in SPLIT_CASES.items():
            at = offset_view if offset else (lambda t: t)
            for pos_list in split_positions(H, KVH, hs, dtype):
                B = len(pos_list)
                need = [p // page + 1 for p in pos_list]
                perm = (torch.randperm(sum(need), generator=gen) + 1).tolist()
                table = torch.zeros((B, S // page), dtype=torch.int32)
                for b, n in enumerate(need):
                    table[b, :n] = torch.tensor(perm[sum(need[:b]) : sum(need[: b + 1])], dtype=torch.int32)
                table = table.cuda()
                pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
                wpage = table[torch.arange(B, device="cuda"), (pos // page).long()].contiguous()
                coords = (table, wpage, (pos % page).contiguous(), layer, pos)
                pools = [at(randn(L, sum(need) + 1, KVH, page, hs, dtype=dtype)) for _ in "kv"]
                q = randn(B, H, hs, dtype=dtype)
                kn, vn = at(randn(B, KVH, 1, hs, dtype=dtype)), at(randn(B, KVH, 1, hs, dtype=dtype))
                qkv = at(randn(B, H + 2 * KVH, hs, dtype=dtype))
                cos_il, sin_il = rope_tables(pos, hs)
                for tag, which, act, news, rows, plain in (
                    ("K15", tpa.paged_decode_attention_stacked, q, (kn, vn), (*pools, kn, vn),
                     lambda c: tpa.paged_decode_attention_stacked_plain(q, *c, table, kn, vn, *coords[1:])[0]),
                    ("K17", tpa.paged_decode_attention_fused, qkv, (cos_il, sin_il), (*pools, qkv),
                     lambda c: tpa.paged_decode_attention_fused_plain(qkv, *c, table, cos_il, sin_il,
                                                                      *coords[1:], H)[0]),
                ):
                    vec = split_vec(case, B, dtype, rows)
                    want_pools = [t.clone() for t in pools]
                    want = plain(want_pools)
                    for splits in (None, 3) if B == 8 else (None,):
                        runs = [[at(t.clone()) for t in pools] for _ in range(2)]
                        n0 = which.launches
                        got, again = (tpa._fp_launch(which, act, *c, *news, *coords, H, splits=splits)
                                      for c in runs)
                        torch.cuda.synchronize()
                        if which.launches != n0 + 2:
                            raise AssertionError(f"{tag}: {which.launches - n0} launches for 2 calls")
                        err = compare(got, want, dtype)
                        if not all(torch.equal(a, b) and torch.equal(a, w) for a, b, w in zip(*runs, want_pools)):
                            raise AssertionError(f"{tag} pool append wrong at {case} pos={pos_list} {splits=}")
                        split_rerun_checks(f"{tag} {case} splits={splits}", got, again, pos_list)
                        say(tag, dtype=dtype_name(dtype), layout=case, B=B, page=page,
                            pos=",".join(map(str, pos_list)), vec=vec, splits=splits or "plan",
                            max_abs_err=f"{err:.3e}", append="equal_to_plain", rerun="equal_bits",
                            tickets="zero")
                del pools, want_pools, runs


def read_split_checks(randn) -> None:
    """K3 and K14, read only, on the split form at K2/K4's split checks
    (SPLIT_CASES at split_positions: the one-element-a-lane loop at head size
    46 and one element off 16-byte alignment), at a given scale (0.7 /
    sqrt(hs)). K3 over one layer's caches (B, KVH, S, hs), per-row positions.
    K14 over one layer's pools of 256-row pages handed out shuffled, every
    slot active, the table's entries past each row's last page naming a
    NaN-filled page (the plain version gets the scratch page 0 there), at the
    plan's split count and at 3 and 8 (split edges inside pages) through
    ``_read_launch``'s ``splits``. Against the plain versions at
    ``tolerance``, one launch a call, a rerun bit-equal, every ticket zero
    after, the caches and pools unchanged."""
    import torch

    from llama2_tpu_torch.ops.cuda import attention as fa
    from llama2_tpu_torch.ops.cuda import paged_attention as tpa

    gen = torch.Generator().manual_seed(SEED + 18)
    page = 256
    for dtype in (torch.float32, torch.bfloat16):
        for case, (H, KVH, hs, offset) in SPLIT_CASES.items():
            at = offset_view if offset else (lambda t: t)
            scale = 0.7 / hs**0.5
            for pos_list in split_positions(H, KVH, hs, dtype):
                B = len(pos_list)
                pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
                q = randn(B, H, hs, dtype=dtype)
                k, v = at(randn(B, KVH, S, hs, dtype=dtype)), at(randn(B, KVH, S, hs, dtype=dtype))
                k0, v0 = k.clone(), v.clone()
                vec = split_vec(case, B, dtype, (k, v))
                n0 = fa.flash_decode_attention.launches
                got, again = (fa.flash_decode_attention(q, k, v, pos, scale=scale) for _ in range(2))
                if fa.flash_decode_attention.launches != n0 + 2:
                    raise AssertionError(f"K3: {fa.flash_decode_attention.launches - n0} launches for 2 calls")
                want = fa.flash_decode_attention_plain(q, k, v, pos, scale=scale)
                torch.cuda.synchronize()
                err = compare(got, want, dtype)
                if not (torch.equal(k, k0) and torch.equal(v, v0)):
                    raise AssertionError(f"K3 wrote to its read-only caches at {case} pos={pos_list}")
                split_rerun_checks(f"K3 {case}", got, again, pos_list)
                say("K3", dtype=dtype_name(dtype), layout=case, B=B, pos=",".join(map(str, pos_list)), vec=vec,
                    scale=f"{scale:.4f}", max_abs_err=f"{err:.3e}", rerun="equal_bits", tickets="zero",
                    caches="unchanged")
                del k, v, k0, v0
                need = [p // page + 1 for p in pos_list]
                nan_page = sum(need) + 1
                perm = (torch.randperm(sum(need), generator=gen) + 1).tolist()
                table = torch.zeros((B, S // page), dtype=torch.int32)
                for b, n in enumerate(need):
                    table[b, :n] = torch.tensor(perm[sum(need[:b]) : sum(need[: b + 1])], dtype=torch.int32)
                table = table.cuda()
                used = torch.arange(S // page, device="cuda")[None] <= (pos // page)[:, None]
                nan_table = torch.where(used, table, torch.full_like(table, nan_page))
                kp, vp = at(randn(nan_page + 1, KVH, page, hs, dtype=dtype)), at(randn(nan_page + 1, KVH, page, hs,
                                                                                       dtype=dtype))
                kp[nan_page], vp[nan_page] = float("nan"), float("nan")
                kp0, vp0 = kp.clone(), vp.clone()
                vec = split_vec(case, B, dtype, (kp, vp))
                want = tpa.paged_decode_attention_plain(q, kp, vp, table, pos, scale=scale)
                for splits in (None, 3, 8):
                    n0 = tpa.paged_decode_attention.launches
                    if splits is None:
                        got, again = (tpa.paged_decode_attention(q, kp, vp, nan_table, pos, scale=scale)
                                      for _ in range(2))
                    else:
                        got, again = (tpa._read_launch(q, kp, vp, nan_table, pos, scale, splits=splits)
                                      for _ in range(2))
                    torch.cuda.synchronize()
                    if tpa.paged_decode_attention.launches != n0 + 2:
                        raise AssertionError(f"K14: {tpa.paged_decode_attention.launches - n0} launches for 2 calls")
                    err = compare(got, want, dtype)
                    if not (torch.equal(kp.nan_to_num(), kp0.nan_to_num())
                            and torch.equal(vp.nan_to_num(), vp0.nan_to_num())):
                        raise AssertionError(f"K14 wrote to its read-only pools at {case} pos={pos_list}")
                    split_rerun_checks(f"K14 {case} splits={splits}", got, again, pos_list)
                    say("K14", dtype=dtype_name(dtype), layout=case, B=B, page=page,
                        pos=",".join(map(str, pos_list)), vec=vec, splits=splits or "plan", scale=f"{scale:.4f}",
                        unused_entries="a_NaN_page", max_abs_err=f"{err:.3e}", rerun="equal_bits",
                        tickets="zero", pools="unchanged")
                del kp, vp, kp0, vp0
    torch.cuda.empty_cache()


# the rmsnorm (K19) and swiglu (K20) check shapes: the benchmark's, then the
# JAX tests' ragged ones (288, 64, 172 wide; 768, 64, 172)
NORM_SHAPES = ((256, 4096), (1024, 8192), (1, 1, 288), (2, 7, 64), (1, 300, 172))
SWIGLU_SHAPES = ((256, 11008), (512, 11008), (1, 1, 768), (2, 7, 64), (1, 300, 172))


def norm_tolerance(dtype) -> tuple[float, float]:
    """(rtol, atol) of K19 against its plain version. fp32: ``tolerance``.
    bf16: the norm rounds twice, to bf16 after the scale and again after the
    weight, and the kernel's float32 sum of squares is taken in another order
    than the plain version's, which can tip the first rounding by one step;
    the weight carries that step into the second: two last-bit steps, 2^-6
    of |want|."""
    import torch

    return tolerance(dtype) if dtype == torch.float32 else (2**-6, 1e-3)


def phase_kernels_bench() -> None:
    """K3, K14, K19 and K20 (the kernel benchmarks' path) against their plain
    versions on the card, fp32 and bf16.

    K3 over one layer's S = 4096 caches at the three head layouts: three rows
    at pos 0, 256 and 4095 (a per-row tensor), then each of those as an int;
    the caches unchanged. K14 over one layer's pools of 256- and 128-row
    pages at 8 slots (``paged_positions``, pages shuffled by ``paged_table``,
    the last two slots on the scratch page 0), the 7B and GQA layouts: past
    each row's last page the kernel's table names a NaN-filled page; the
    plain version, which gathers the longest row's page count for every row,
    gets the same table with valid pages there. Outputs equal within
    ``tolerance`` and finite, the pools unchanged. K19 and K20 at
    ``NORM_SHAPES`` and ``SWIGLU_SHAPES``, K19 under a weight of the rows'
    dtype and a float32 one, to ``norm_tolerance``; the output in the rows'
    dtype. Each call one launch. Then K3 and K14 at the split form's checks
    (``read_split_checks``)."""
    import torch

    from llama2_tpu_torch.ops.cuda import attention as fa
    from llama2_tpu_torch.ops.cuda import paged_attention as tpa
    from llama2_tpu_torch.ops.cuda.rmsnorm import rmsnorm, rmsnorm_plain
    from llama2_tpu_torch.ops.cuda.swiglu import swiglu, swiglu_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    cpu_gen = torch.Generator().manual_seed(SEED + 15)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def launched(wrapper, *args):
        n0 = wrapper.launches
        out = wrapper(*args)
        if wrapper.launches != n0 + 1:
            raise AssertionError(f"{wrapper.__name__}: {wrapper.launches - n0} launches for one call")
        return out

    for dtype in (torch.float32, torch.bfloat16):
        dn = dtype_name(dtype)
        rtol, atol = tolerance(dtype)
        for lname, (H, KVH, hs) in LAYOUTS.items():
            k, v = randn(3, KVH, S, hs, dtype=dtype), randn(3, KVH, S, hs, dtype=dtype)
            k0, v0 = k.clone(), v.clone()
            rows = [0, 256, S - 1]
            worst = 0.0
            for q, pos in [(randn(3, 1, H, hs, dtype=dtype), torch.tensor(rows, dtype=torch.int32, device="cuda"))] + [
                    (randn(3, H, hs, dtype=dtype), p) for p in rows]:
                got = launched(fa.flash_decode_attention, q, k, v, pos)
                want = fa.flash_decode_attention_plain(q, k, v, pos)
                torch.cuda.synchronize()
                if got.shape != q.shape or got.dtype != dtype:
                    raise AssertionError(f"K3 gave {got.dtype} {tuple(got.shape)} for q {tuple(q.shape)}")
                worst = max(worst, compare(got, want, dtype))
            if not (torch.equal(k, k0) and torch.equal(v, v0)):
                raise AssertionError("K3 wrote to its read-only caches")
            say("K3", dtype=dn, layout=lname, B=3, pos=",".join(map(str, rows)) + "_per_row_and_each_as_int",
                max_abs_err=f"{worst:.3e}", rtol=rtol, atol=atol, caches="unchanged")
            del k, v, k0, v0
        for lname in ("7B", "GQA"):
            H, KVH, hs = LAYOUTS[lname]
            for page in (256, 128):
                pos_list = paged_positions(page)
                n_pages = sum(p // page + 1 for p in pos_list[: len(pos_list) - N_INACTIVE]) + 1
                table = paged_table(pos_list, page, n_pages, cpu_gen).cuda()
                pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
                kp = randn(n_pages + 1, KVH, page, hs, dtype=dtype)
                vp = randn(n_pages + 1, KVH, page, hs, dtype=dtype)
                kp[n_pages], vp[n_pages] = float("nan"), float("nan")
                used = torch.arange(table.shape[1], device="cuda")[None] <= (pos // page)[:, None]
                nan_table = torch.where(used, table, torch.full_like(table, n_pages))
                q = randn(len(pos_list), H, hs, dtype=dtype)
                kp0 = kp.clone()
                got = launched(tpa.paged_decode_attention, q, kp, vp, nan_table, pos)
                want = tpa.paged_decode_attention_plain(q, kp, vp, table, pos)
                torch.cuda.synchronize()
                err = compare(got, want, dtype)
                if not torch.equal(kp.nan_to_num(), kp0.nan_to_num()):
                    raise AssertionError("K14 wrote to its read-only pool")
                say("K14", dtype=dn, layout=lname, page=page, pool_pages=n_pages + 1,
                    pos=",".join(map(str, pos_list)), unused_entries="a_NaN_page", max_abs_err=f"{err:.3e}",
                    rtol=rtol, atol=atol, finite=True)
                del kp, vp, kp0
        nrtol, natol = norm_tolerance(dtype)
        for shape in NORM_SHAPES:
            x = randn(*shape, dtype=dtype)
            for wdt in dict.fromkeys((dtype, torch.float32)):
                w = 1 + 0.1 * randn(shape[-1], dtype=wdt)
                got = launched(rmsnorm, x, w)
                if got.dtype != dtype or got.shape != x.shape:
                    raise AssertionError(f"K19 gave {got.dtype} {tuple(got.shape)} for {dtype} rows")
                err = compare(got, rmsnorm_plain(x, w), dtype, (nrtol, natol))
                say("K19", dtype=dn, weight=dtype_name(wdt), shape="x".join(map(str, shape)),
                    out_dtype=dtype_name(got.dtype), max_abs_err=f"{err:.3e}", rtol=nrtol, atol=natol)
        for shape in SWIGLU_SHAPES:
            h1, h3 = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
            got = launched(swiglu, h1, h3)
            if got.dtype != dtype or got.shape != h1.shape:
                raise AssertionError(f"K20 gave {got.dtype} {tuple(got.shape)} for {dtype} rows")
            err = compare(got, swiglu_plain(h1, h3), dtype)
            say("K20", dtype=dn, shape="x".join(map(str, shape)), out_dtype=dtype_name(got.dtype),
                max_abs_err=f"{err:.3e}", rtol=rtol, atol=atol)
    torch.cuda.empty_cache()
    read_split_checks(randn)


BATCH8_POS = [0, 255, 256, 1000, S - 1, 77, 3000, 2047]


def phase_kernels_batch8() -> None:
    """The kernels the batched engines run at 8 rows with positions of their
    own, against their plain versions at their tolerances: K4 (fp32 and bf16
    caches) and K9 (int8 cache, planted faults at 4095) at the 7B and the
    GQA layout, and K13 at the 7B widths with and without the qkv phase;
    appends equal to the plain version's."""
    import torch

    from llama2_tpu_torch.ops.cuda import attention_q8 as aq
    from llama2_tpu_torch.ops.cuda import layer_block as lb
    from llama2_tpu_torch.ops.cuda.attention import (
        flash_decode_attention_fused,
        flash_decode_attention_fused_plain,
    )
    from llama2_tpu_torch.quant.q8 import QuantTensor

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    L, B = 2, len(BATCH8_POS)
    pos = torch.tensor(BATCH8_POS, dtype=torch.int32, device="cuda")

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for lname in ("7B", "GQA"):
        H, KVH, hs = LAYOUTS[lname]
        cos_il, sin_il = rope_tables(pos, hs)
        for dtype in (torch.float32, torch.bfloat16):
            kc, vc = randn(L, B, KVH, S, hs, dtype=dtype), randn(L, B, KVH, S, hs, dtype=dtype)
            qkv = randn(B, H + 2 * KVH, hs, dtype=dtype)
            k1, v1 = kc.clone(), vc.clone()
            got = flash_decode_attention_fused(qkv, k1, v1, cos_il, sin_il, 1, pos, n_heads=H)
            want = flash_decode_attention_fused_plain(qkv, kc, vc, cos_il, sin_il, 1, pos, H)
            torch.cuda.synchronize()
            err = compare(got, want, dtype)
            if not (torch.equal(k1, kc) and torch.equal(v1, vc)):
                raise AssertionError(f"K4 at 8 rows: appends differ from the plain version's ({lname})")
            say("K4", dtype=dtype_name(dtype), layout=lname, B=B, pos=",".join(map(str, BATCH8_POS)),
                max_abs_err=f"{err:.3e}", append="equal_to_plain")
            del kc, vc, k1, v1
            caches = [*aq.quantize_kv_rows(randn(L, B, KVH, S, hs)), *aq.quantize_kv_rows(randn(L, B, KVH, S, hs))]
            c1 = [t.clone() for t in caches]
            got = aq.flash_decode_attention_q8_fused(qkv, *c1, cos_il, sin_il, 1, pos, n_heads=H)
            want = aq.flash_decode_attention_q8_fused_plain(qkv, *caches, cos_il, sin_il, 1, pos, H)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(c1, caches)):
                raise AssertionError(f"K9 at 8 rows: appends differ from the plain version's ({lname})")
            q_rot = aq.rope_quantize_plain(qkv, cos_il, sin_il, H)[0]
            terms = (q_rot[:, None], *[t[1] for t in caches], pos.long()[:, None])
            _, A, R = q8kv_terms(*terms)
            tol = q8kv_tolerance(dtype, A[:, 0], R[:, 0])
            err = compare(got, want, dtype, tol)
            planted_faults_fail(want, dtype, tol, terms, lambda o: o[:, 0].to(dtype), f"K9 B=8 {lname}")
            say("K9", dtype=dtype_name(dtype), layout=lname, B=B, pos=",".join(map(str, BATCH8_POS)),
                max_abs_err=f"{err:.3e}", planted_faults_at_4095="fail", append="equal_to_plain")
            del caches, c1
            torch.cuda.empty_cache()

    # K13 at the 7B widths, 8 rows
    def qt(L, K, N):
        q = torch.randint(-127, 128, (L, K, N), generator=gen, device="cuda", dtype=torch.int8)
        return QuantTensor(q, 2.7e-4 * (0.7 + 0.6 * torch.rand((L, K // GROUP, N), generator=gen, device="cuda")),
                           GROUP)

    H, KVH, hs = LAYOUTS["7B"]
    D, HD = H * hs, 11008
    weights = [qt(L, D, D), None, qt(L, D, HD), qt(L, D, HD), qt(L, HD, D), None, qt(L, D, (H + 2 * KVH) * hs)]
    cos_il, sin_il = rope_tables(pos, hs)
    for dtype in (torch.float32, torch.bfloat16):
        weights[1], weights[5] = 1 + 0.1 * randn(L, D, dtype=dtype), 1 + 0.1 * randn(L, D, dtype=dtype)
        caches = [*aq.quantize_kv_rows(randn(L, B, KVH, S, hs)), *aq.quantize_kv_rows(randn(L, B, KVH, S, hs))]
        qkv3, x = randn(B, H + 2 * KVH, hs, dtype=dtype), randn(B, D, dtype=dtype)
        worst = {}
        for with_qkv in (True, False):
            layer = 0 if with_qkv else L - 1
            c1 = [t.clone() for t in caches]
            got = lb.layer_block_stacked(qkv3, x, *c1, cos_il, sin_il, *weights, layer, pos, n_heads=H,
                                         with_qkv=with_qkv)
            c2 = [t.clone() for t in caches]
            want = lb.layer_block_stacked_plain(qkv3, x, *c2, cos_il, sin_il, *weights, layer, pos, n_heads=H,
                                                with_qkv=with_qkv)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(c1, c2)):
                raise AssertionError("K13 at 8 rows: appends differ from the plain version's")
            rtol = 0.0 if dtype == torch.float32 else 2**-7
            for i, tag in enumerate(("out", "qkv")[: 2 if with_qkv else 1]):
                scale = float(want[i].float().abs().max())
                e = compare(got[i], want[i], dtype, (rtol, K13_PLAIN_TOL * scale))
                worst[f"{tag}_with_qkv" if with_qkv else tag] = e / scale
            del c1, c2
        say("K13", dtype=dtype_name(dtype), B=B, pos=",".join(map(str, BATCH8_POS)), with_qkv="true,false",
            tol=f"{K13_PLAIN_TOL}*max|want|", append="equal_to_plain",
            **{f"{k}_err_over_max": f"{v:.2e}" for k, v in worst.items()})
        del caches
    del weights
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 3


def config_7b(n_layers: int = 32):
    from llama2_tpu_torch.config import ModelConfig

    return ModelConfig(
        dim=4096, hidden_dim=11008, n_layers=n_layers, n_heads=32, n_kv_heads=32,
        vocab_size=32000, seq_len=4096,
    )


def prompt_tokens() -> list[int]:
    from llama2_tpu_torch.tokenizer.tokenizer import Tokenizer

    tok = Tokenizer.from_file(TOKENIZER_BIN, 32000)
    text = (
        "Once upon a time, there was a little girl named Lily. She loved to "
        "play outside in the park with her friends, and every morning she "
        "walked past the old bakery where the baker gave her a warm roll. "
    ) * 6
    ids = tok.encode(text)
    if len(ids) < PROMPT_TOKENS:
        raise AssertionError(f"prompt text gives only {len(ids)} tokens")
    return ids[:PROMPT_TOKENS]


def teacher_forced_logits(params, config, stream: list[int], n_prompt: int, backend: str,
                          kv_quant: bool = False, window: int = 1, offset: int = 0):
    """Logits of every sampled position of ``stream`` (= [BOS] + prompt +
    generated) through one prefill and then segments of ``window`` tokens (1:
    decode steps; d: the verify windows of speculative decoding; ``offset``
    tokens first, to shift where the windows fall), on ``backend``, over an
    fp or an int8 cache, as float32 on the host."""
    import torch

    from llama2_tpu_torch.models.llama import (
        activation_dtype,
        forward,
        init_cache,
        logits_from_hidden,
    )

    dev = params["rms_final"].device
    cache = init_cache(config, 1, activation_dtype(params), dev, kv_quant, pad=window - 1)
    out = []
    tok = torch.tensor([stream[: n_prompt + 1]], device=dev)
    h = forward(params, cache, tok, 0, config, backend)
    out.append(logits_from_hidden(params, h[:, -1], backend)[0].cpu())
    p = n_prompt + 1
    while p < len(stream):
        t = offset if p == n_prompt + 1 and offset else window
        tok = torch.tensor([stream[p : p + t]], device=dev)
        h = forward(params, cache, tok, p, config, backend)
        out.extend(logits_from_hidden(params, h[0], backend).cpu())
        p += t
    return torch.stack(out)


# fp32: the two paths differ only in the attention kernels' summation order,
# and logits are O(1) at this init (random_params scale 0.02), so an
# absolute bound. bf16: the paths round attention outputs to bf16 at
# different last bits and 32 layers carry that, so each bf16 path is held
# against the fp32 computation with the SAME (bf16-rounded) weights: the
# kernel path's max and mean abs logit distance from it may exceed the plain
# path's by at most BF16_MAX_MARGIN (absolute) and BF16_MEAN_MARGIN (relative).
F32_LOGIT_ATOL = 1e-3
BF16_MAX_MARGIN = 0.05
BF16_MEAN_MARGIN = 0.02


def profile_steps(dn: str, where: str, run) -> None:
    """Where a decode step's time goes: ``run()`` under torch.profiler returns
    (forward steps, wall seconds). Prints wall, device (kernel time summed)
    and host (the rest) ms per step, the device busy share (device over wall;
    tracing adds host time, so it is a lower bound) and the kernels with the
    most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        n, wall_s = run()
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    wall_ms = wall_s * 1e3
    say("profile", dtype=dn, where=where, forward_steps=n, wall_ms_per_step=f"{wall_ms / n:.3f}",
        device_ms_per_step=f"{dev_ms / n:.3f}" if kernels else "not_measured",
        host_ms_per_step=f"{(wall_ms - dev_ms) / n:.3f}" if kernels else "not_measured",
        device_busy_share=f"{dev_ms / wall_ms:.3f}" if kernels else "not_measured")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        say("profile", dtype=dn, where=where, kernel=e.key[:60].replace(" ", "_"), calls=e.count,
            device_ms_per_step=f"{e.self_device_time_total / 1e3 / n:.4f}")
    # the port's own kernels, whatever their rank
    for e in kernels:
        for name in ("decode_kernel", "decode_fused_kernel", "attention_q8_kernel", "gemv_kernel",
                     "mlp_block_kernel", "paged_decode_kernel", "paged_decode_fused_kernel",
                     "paged_attention_q8_kernel"):
            if f"::{name}<" in e.key or f"::{name}(" in e.key or e.key.startswith(name):
                say("profile", dtype=dn, where=where, port_kernel=name, calls=e.count,
                    device_us_per_call=f"{e.self_device_time_total / e.count:.2f}",
                    device_ms_per_step=f"{e.self_device_time_total / 1e3 / n:.4f}")


def decode_profile(g, dn: str) -> None:
    """``profile_steps`` of 16 greedy steps from an empty prompt (its
    one-token prefill is a decode-kernel step too): positions 0..16."""
    from llama2_tpu_torch.config import GenerationConfig

    steps = 16

    def run():
        res = g.generate([], GenerationConfig(temperature=0.0, steps=steps))
        # forward steps run: the one-token prefill, one per emitted token, and
        # one more when a BOS ended the loop early
        return len(res.tokens) + (1 if len(res.tokens) == steps else 2), res.total_s

    profile_steps(dn, "pos_0_to_16", run)


def long_context_profile(g, config, dn: str, steps: int = 16, pos0: int | None = None) -> None:
    """``profile_steps`` of ``steps`` decode steps from ``pos0`` (default the
    last ``steps`` of the context, positions seq_len - steps .. seq_len - 1),
    each a forward, the logits and the argmax's host sync, as the
    Generator's loop runs them, over a cache whose earlier rows are filled
    with random values (int8 rows under scales of a N(0, 1) row's size, or
    N(0, 1) rows)."""
    import torch

    from llama2_tpu_torch.models.llama import forward, init_cache, logits_from_hidden
    from llama2_tpu_torch.ops import sampling

    dev = g.params["rms_final"].device
    cache = init_cache(config, 1, g.dtype, dev, g.kv_quant)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    for name, t in cache.items():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=dev, dtype=torch.int8))
        elif name.endswith("scale"):
            t.copy_(0.02 + 0.01 * torch.rand(t.shape, generator=gen, device=dev))
        else:
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    if pos0 is None:
        pos0 = config.seq_len - steps

    def run(n=steps):
        tok = 1
        t0 = time.perf_counter()
        for i in range(n):
            h = forward(g.params, cache, torch.tensor([[tok]], device=dev), pos0 + i, config, g.backend)
            logits = logits_from_hidden(g.params, h[:, -1:, :], g.backend)
            tok = int(sampling.sample_argmax(logits[0, -1]))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{dn}: non-finite logits at pos {pos0 + n - 1}")
        return n, time.perf_counter() - t0

    run(2)  # warm-up at these positions
    profile_steps(dn, f"pos_{pos0}_to_{pos0 + steps - 1}", run)
    del cache
    torch.cuda.empty_cache()


def phase_generate(dtype, n_layers: int = 32) -> dict:
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io.convert import random_params
    from llama2_tpu_torch.ops.cuda.attention import flash_decode_attention_stacked as k2
    from llama2_tpu_torch.ops.cuda.prefill_attention import flash_prefill_attention as k1
    from llama2_tpu_torch.runtime.generator import BOS, Generator

    config = config_7b(n_layers)
    dn = f"{dtype_name(dtype)}/{n_layers}L"
    t0 = time.perf_counter()
    params = random_params(config, SEED, "cuda", dtype)
    torch.cuda.synchronize()
    say("gen", dtype=dn, params_built_s=f"{time.perf_counter() - t0:.1f}")
    g = Generator(config, params, dtype=dtype, backend="cuda", device="cuda")
    prompt = prompt_tokens()
    # warm-up: cuBLAS handles and workspaces, kernel libraries loaded
    g.generate(prompt[:8], GenerationConfig(temperature=0.0, steps=10))

    torch.cuda.reset_peak_memory_stats()
    k1.launches = k1.launches_mma = k1.launches_tf32 = k1.launches_fma = 0
    k2.launches = 0
    res = g.generate(
        prompt, GenerationConfig(temperature=0.0, steps=len(prompt) + GEN_TOKENS)
    )
    launches = {"K1": k1.launches, "K2": k2.launches}
    # the 7B head (hs 128): bf16 and fp32 each through its tensor-core variant
    variant = k1.launches_mma if dtype == torch.bfloat16 else k1.launches_tf32
    if variant != launches["K1"]:
        raise AssertionError(f"{dtype_name(dtype)}: {variant} of {launches['K1']} K1 launches "
                             "took the variant of its dtype")
    peak = torch.cuda.max_memory_allocated()

    generated = res.tokens[len(prompt):]
    n_gen = len(generated)
    decode_steps = n_gen + (1 if n_gen < GEN_TOKENS else 0)  # a BOS stop still ran its step
    if res.tokens[: len(prompt)] != prompt or not all(0 <= t < config.vocab_size for t in generated):
        raise AssertionError("generate returned a malformed token stream")
    if launches["K1"] != config.n_layers or launches["K2"] != config.n_layers * decode_steps:
        raise AssertionError(
            f"launches {launches}: want K1={config.n_layers} (one prefill chunk), "
            f"K2={config.n_layers}x{decode_steps} decode steps"
        )
    decode_s = res.total_s - res.ttft_s
    say("gen", dtype=dn, prompt_tokens=len(prompt), generated=n_gen,
        K1_launches=launches["K1"], K2_launches=launches["K2"],
        K1_per_prefill_chunk=launches["K1"], K2_per_decode_step=launches["K2"] // decode_steps)
    say("gen", dtype=dn, ttft_ms=f"{res.ttft_s * 1e3:.2f}",
        decode_tok_s=f"{n_gen / decode_s:.2f}",
        reference_protocol_tok_s=f"{res.tokens_per_sec:.2f}",
        peak_mem_GiB=f"{peak / 2**30:.2f}")

    decode_profile(g, dn)

    stream = [BOS] + res.tokens
    lc = teacher_forced_logits(g.params, config, stream, len(prompt), "cuda")
    lt = teacher_forced_logits(g.params, config, stream, len(prompt), "torch")
    if lc.shape != (n_gen + 1, config.vocab_size) or not bool(torch.isfinite(lc).all()):
        raise AssertionError(f"teacher-forced logits malformed: {tuple(lc.shape)}")
    diff = float((lc - lt).abs().max())
    same_greedy = lt[:n_gen].argmax(-1).tolist() == generated
    same_replay = lc[:n_gen].argmax(-1).tolist() == generated
    say("gen", dtype=dn, logit_max_abs_diff_cuda_vs_torch=f"{diff:.3e}",
        logit_absmax=f"{float(lt.abs().max()):.3f}",
        greedy_tokens_identical=same_greedy, cuda_replay_matches_generate=same_replay)
    if not same_replay:
        raise AssertionError(f"{dn}: the teacher-forced cuda replay disagrees with generate")
    if dtype == torch.float32:
        if diff > F32_LOGIT_ATOL:
            raise AssertionError(f"f32: cuda vs torch logits differ by {diff} > {F32_LOGIT_ATOL}")
    else:
        del g, params
        torch.cuda.empty_cache()
        ref_params = {k: v.float() for k, v in random_params(config, SEED, "cuda", dtype).items()}
        lr = teacher_forced_logits(ref_params, config, stream, len(prompt), "torch")
        dc, dt = (lc - lr).abs(), (lt - lr).abs()
        max_c, max_t = float(dc.max()), float(dt.max())
        mean_c, mean_t = float(dc.mean()), float(dt.mean())
        say("gen", dtype=dn, vs_f32_same_weights_max_cuda=f"{max_c:.4e}",
            vs_f32_same_weights_max_torch=f"{max_t:.4e}", max_margin=BF16_MAX_MARGIN,
            vs_f32_same_weights_mean_cuda=f"{mean_c:.4e}",
            vs_f32_same_weights_mean_torch=f"{mean_t:.4e}", mean_margin=BF16_MEAN_MARGIN)
        if max_c > max_t + BF16_MAX_MARGIN or mean_c > mean_t * (1 + BF16_MEAN_MARGIN):
            raise AssertionError(
                f"bf16: the kernel path is {max_c} (max) / {mean_c} (mean) from the f32 "
                f"logits, the plain path {max_t} / {mean_t}: past the margins"
            )
        del ref_params
    g = params = None
    torch.cuda.empty_cache()
    return launches


# The Q8 fast path against the plain path, bf16 activations: the plain path
# rounds every dequantized weight to bf16 before its matmul and the kernel
# path does not, so the two are held against the fp32-activation plain path
# on the same INT8 weights, with the margins of the bf16-weight check above.
# cuda-accurate in fp32 differs from the plain path only in summation order,
# so it is held to F32_LOGIT_ATOL as the fp32-weight path is.


class VariantCount:
    """One variant's launch count of a kernel wrapper (``attr`` on it), read
    and reset as a wrapper's ``launches`` is."""

    def __init__(self, fn, attr: str):
        self.fn, self.attr = fn, attr

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n: int) -> None:
        setattr(self.fn, self.attr, n)


def k1_variants(counts: dict, dtype) -> dict:
    """``counts`` with K1's launches also under the variant a 7B head (hs 128)
    takes in ``dtype``: "K1-mma" for bf16, "K1-tf32" for fp32 (none on FMA)."""
    if "K1" not in counts:
        return counts
    return {**counts, f"K1-{k1_variant(dtype, 128)}": counts["K1"]}


def count_launches() -> dict:
    from llama2_tpu_torch.ops.cuda.attention import (
        flash_decode_attention_fused,
        flash_decode_attention_stacked,
    )
    from llama2_tpu_torch.ops.cuda.mlp_block import (
        attn_mlp_block_stacked,
        layer_tail_qkv_stacked,
        mlp_block_stacked,
    )
    from llama2_tpu_torch.ops.cuda.attention_q8 import (
        flash_decode_attention_q8,
        flash_decode_attention_q8_fused,
        flash_decode_attention_q8_stacked,
    )
    from llama2_tpu_torch.ops.cuda.layer_block import layer_block_stacked
    from llama2_tpu_torch.ops.cuda.paged_attention import (
        paged_decode_attention_fused,
        paged_decode_attention_q8_fused,
        paged_decode_attention_q8_stacked,
        paged_decode_attention_stacked,
    )
    from llama2_tpu_torch.ops.cuda.prefill_attention import flash_prefill_attention
    from llama2_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_stacked

    return {
        "K1": flash_prefill_attention,
        "K1-mma": VariantCount(flash_prefill_attention, "launches_mma"),
        "K1-tf32": VariantCount(flash_prefill_attention, "launches_tf32"),
        "K1-fma": VariantCount(flash_prefill_attention, "launches_fma"),
        "K2": flash_decode_attention_stacked,
        "K4": flash_decode_attention_fused, "K5": quant_matmul, "K6": quant_matmul_stacked,
        # accurate mode's M > 8 tile (the prefill chunk's projections; its
        # classifier runs on the last position only, M = 1), counted apart
        "K6-tile-acc": VariantCount(quant_matmul_stacked, "launches_tile_accurate"),
        "K7": flash_decode_attention_q8, "K8": flash_decode_attention_q8_stacked,
        "K9": flash_decode_attention_q8_fused, "K10": mlp_block_stacked,
        "K11": attn_mlp_block_stacked, "K12": layer_tail_qkv_stacked, "K13": layer_block_stacked,
        # the megakernels' tensor-core form (3 or more rows), counted apart
        "K11-mma": VariantCount(attn_mlp_block_stacked, "launches_mma"),
        "K12-mma": VariantCount(layer_tail_qkv_stacked, "launches_mma"),
        "K13-mma": VariantCount(layer_block_stacked, "launches_mma"),
        "K15": paged_decode_attention_stacked, "K16": paged_decode_attention_q8_stacked,
        "K17": paged_decode_attention_fused, "K18": paged_decode_attention_q8_fused,
    }


# The routes of the INT8-weight path: (launches per prefill chunk, launches per
# decode step) for L layers; a kernel not named launches 0 times. "int8kv"
# routes run over the int8 KV cache, where a 201-token prefill chunk (> 16
# tokens) attends through the dequantized cache, outside any kernel.
Q8_ROUTES = {
    # the main path of the int8 cache: one whole-layer launch a layer
    "int8kv": (lambda L: {"K6": 5 * L, "K5": 1},
               lambda L: {"K6": 1, "K13": L, "K5": 1}),
    # the whole-layer kernel switched off: int8 glue-fused attention + K12/K11
    "int8kv-two-launch": (lambda L: {"K6": 5 * L, "K5": 1},
                          lambda L: {"K6": 1, "K9": L, "K12": L - 1, "K11": 1, "K5": 1}),
    "int8kv-accurate": (lambda L: {"K6": 4 * L, "K5": 1, "K6-tile-acc": 4 * L},
                        lambda L: {"K6": 4 * L, "K8": L, "K5": 1}),
    # bf16 weights (cuBLAS projections): the int8 stacked attention only
    "int8kv-fp": (lambda L: {}, lambda L: {"K8": L}),
    # glue-fused attention + the wo/FFN/next-QKV megakernel; layer 0's QKV and
    # the last layer's megakernel without the QKV phase are launches of their own
    "two-launch": (lambda L: {"K6": 5 * L, "K1": L, "K5": 1},
                   lambda L: {"K6": 1, "K4": L, "K12": L - 1, "K11": 1, "K5": 1}),
    # the w13 layout: wqkv, wo, w13, w2 a layer
    "composed": (lambda L: {"K6": 4 * L, "K1": L, "K5": 1},
                 lambda L: {"K6": 4 * L, "K4": L, "K5": 1}),
    # wo in bf16: wqkv, w1, w3, w2 in prefill; wqkv + the FFN-only megakernel in decode
    "ffn-only": (lambda L: {"K6": 4 * L, "K1": L, "K5": 1},
                 lambda L: {"K6": L, "K4": L, "K10": L, "K5": 1}),
    # the prefill chunk's K6 all through the accurate M > 8 tile
    "accurate": (lambda L: {"K6": 4 * L, "K1": L, "K5": 1, "K6-tile-acc": 4 * L},
                 lambda L: {"K6": 4 * L, "K2": L, "K5": 1}),
}
# fast mode rounds every matmul operand to bf16; with fp32 activations that is
# its only difference from the plain path, which dequantizes to fp32: the JAX
# kernel tests' bar for the fast kernel against the float32 oracle, 3e-2, here
# of the largest logit
F32_FAST_LOGIT_RTOL = 3e-2


def run_counted(g, prompt: list[int]):
    """One ``generate`` of the prompt plus GEN_TOKENS greedy tokens with every
    launch counter set to 0 just before and read just after: (result,
    launches, peak memory in bytes)."""
    import torch

    from llama2_tpu_torch.config import GenerationConfig

    torch.cuda.reset_peak_memory_stats()
    wrappers = count_launches()
    for w in wrappers.values():
        w.launches = 0
    res = g.generate(prompt, GenerationConfig(temperature=0.0, steps=len(prompt) + GEN_TOKENS))
    return res, {k: w.launches for k, w in wrappers.items()}, torch.cuda.max_memory_allocated()


def phase_generate_q8(route: str, backend: str, dtype, n_layers: int = 32,
                      speculative: bool = False, fp_stream=None) -> dict:
    """One route of the INT8-weight path at full 7B width: generate, count
    launches, replay teacher-forced through the plain path; at 32 layers on
    ``cuda``, profile decode steps at positions 0-16 and 4080-4095; with
    ``speculative``, then the same greedy run with 4-token verify windows.
    Routes named "int8kv..." run over the int8 KV cache ("int8kv-fp" on bf16
    weights); ``fp_stream``: the tokens of the same weights over the fp cache,
    to report how far the two streams agree. Returns the launches by kernel
    (and, with ``speculative``, those of the speculative run under "spec")
    and the generated tokens under "tokens"."""
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io.convert import random_params, random_q8_params
    from llama2_tpu_torch.models import llama as model
    from llama2_tpu_torch.models.llama import fuse_layer_params
    from llama2_tpu_torch.quant.q8 import QuantTensor, dequantize
    from llama2_tpu_torch.runtime.generator import BOS, Generator

    config = config_7b(n_layers)
    L = config.n_layers
    kv_quant = route.startswith("int8kv")
    dn = f"q8/{dtype_name(dtype)}/{backend}/{route}/{L}L"
    if route == "int8kv-fp":
        dn = f"{dtype_name(dtype)}/{backend}/{route}/{L}L"
    t0 = time.perf_counter()
    if route == "int8kv-fp":
        params = random_params(config, SEED, "cuda", dtype)
    else:
        params = random_q8_params(config, SEED, "cuda", dtype, group_size=GROUP)
    if route == "composed":  # the Generator fuses an unfused tree only
        params = fuse_layer_params(params, "torch")
    elif route == "ffn-only":  # an fp wo: neither megakernel with a wo phase takes it
        params["wo"] = dequantize(params["wo"], dtype)
    torch.cuda.synchronize()
    say("gen", path=dn, params_built_s=f"{time.perf_counter() - t0:.1f}")
    g = Generator(config, params, dtype=dtype, backend=backend, device="cuda", kv_quant=kv_quant)
    del params
    if route != "composed" and ("w13" in g.params) != (backend == "cuda-accurate"):
        raise AssertionError(f"{dn}: the Generator's params are {sorted(g.params)}")
    # the two-launch int8 route: the model's whole-layer predicate answers
    # no for this phase, as tests/test_layer_block.py forces it
    supported = model.layer_block_supported
    if route == "int8kv-two-launch":
        model.layer_block_supported = lambda *a: False
    try:
        return _generate_q8(g, config, route, backend, dtype, dn, kv_quant, speculative, fp_stream)
    finally:
        model.layer_block_supported = supported


def _generate_q8(g, config, route, backend, dtype, dn, kv_quant, speculative, fp_stream) -> dict:
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.quant.q8 import QuantTensor
    from llama2_tpu_torch.runtime.generator import BOS

    L = config.n_layers
    prompt = prompt_tokens()
    # warm-up: a prefill chunk past 16 tokens takes the main path's prefill route
    g.generate(prompt[:20], GenerationConfig(temperature=0.0, steps=22))

    res, launches, peak = run_counted(g, prompt)

    generated = res.tokens[len(prompt):]
    n_gen = len(generated)
    steps = n_gen + (1 if n_gen < GEN_TOKENS else 0)  # a BOS stop still ran its step
    if res.tokens[: len(prompt)] != prompt or not all(0 <= t < config.vocab_size for t in generated):
        raise AssertionError("generate returned a malformed token stream")
    per_chunk, per_step = (f(L) for f in Q8_ROUTES[route])
    per_chunk = k1_variants(per_chunk, dtype)
    want = {k: per_chunk.get(k, 0) + steps * per_step.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"{dn}: launches {launches}, want {want} ({steps} decode steps)")
    decode_s = res.total_s - res.ttft_s
    say("gen", path=dn, prompt_tokens=len(prompt), generated=n_gen,
        per_prefill_chunk=",".join(f"{k}={v}" for k, v in per_chunk.items()),
        per_decode_step=",".join(f"{k}={v}" for k, v in per_step.items()),
        **{f"{k}_launches": v for k, v in launches.items()})
    say("gen", path=dn, ttft_ms=f"{res.ttft_s * 1e3:.2f}",
        decode_tok_s=f"{n_gen / decode_s:.2f}",
        wall_ms_per_decode_step=f"{decode_s * 1e3 / steps:.3f}",
        reference_protocol_tok_s=f"{res.tokens_per_sec:.2f}",
        peak_mem_GiB=f"{peak / 2**30:.2f}")
    if L == 32 and backend == "cuda":
        decode_profile(g, dn)
        long_context_profile(g, config, dn)

    if fp_stream is not None:
        same = sum(a == b for a, b in zip(generated, fp_stream))
        first = next((i for i, (a, b) in enumerate(zip(generated, fp_stream)) if a != b), n_gen)
        say("gen", path=dn, tokens_equal_to_fp_cache_stream=f"{same}/{n_gen}",
            identical_prefix=first)

    stream = [BOS] + res.tokens
    lc = teacher_forced_logits(g.params, config, stream, len(prompt), backend, kv_quant)
    # the plain path runs the Generator's layout too, on the same kind of cache
    lt = teacher_forced_logits(g.params, config, stream, len(prompt), "torch", kv_quant)
    if lc.shape != (n_gen + 1, config.vocab_size) or not bool(torch.isfinite(lc).all()):
        raise AssertionError(f"teacher-forced logits malformed: {tuple(lc.shape)}")
    diff = float((lc - lt).abs().max())
    absmax = float(lt.abs().max())
    agree = lt[:n_gen].argmax(-1) == torch.tensor(generated)
    same_greedy = bool(agree.all())
    same_replay = lc[:n_gen].argmax(-1).tolist() == generated
    say("gen", path=dn, logit_max_abs_diff_kernel_vs_plain=f"{diff:.3e}",
        logit_absmax=f"{absmax:.3f}",
        greedy_tokens_identical=same_greedy, kernel_replay_matches_generate=same_replay)
    if not same_replay:
        raise AssertionError(f"{dn}: the teacher-forced kernel replay disagrees with generate")
    # over the int8 cache the plain path dequantizes and attends in float32,
    # the kernels take bf16 queries and bf16 p * v_scale: held like fast mode
    if dtype == torch.float32 and backend == "cuda-accurate" and not kv_quant:
        if diff > F32_LOGIT_ATOL or not same_greedy:
            raise AssertionError(
                f"{dn}: kernel vs plain logits differ by {diff} (bound {F32_LOGIT_ATOL}), "
                f"greedy tokens identical: {same_greedy}"
            )
    elif dtype == torch.float32:
        # a token may differ only where the plain path's top two logits are
        # closer than the two paths are
        top2 = lt[:n_gen].topk(2, dim=-1).values
        guarded = (top2[:, 0] - top2[:, 1]) > 2 * diff
        say("gen", path=dn, bound=f"{F32_FAST_LOGIT_RTOL}*logit_absmax",
            positions_with_clear_margin=int(guarded.sum()), of=n_gen,
            tokens_agree_there=bool(agree[guarded].all()))
        if diff > F32_FAST_LOGIT_RTOL * absmax or not bool(agree[guarded].all()):
            raise AssertionError(
                f"{dn}: kernel vs plain logits differ by {diff} "
                f"(bound {F32_FAST_LOGIT_RTOL * absmax}), or a token with a clear margin differs"
            )
    else:
        ref = {k: v if isinstance(v, QuantTensor) else v.float() for k, v in g.params.items()}
        lr = teacher_forced_logits(ref, config, stream, len(prompt), "torch", kv_quant)
        dc, dt = (lc - lr).abs(), (lt - lr).abs()
        max_c, max_t = float(dc.max()), float(dt.max())
        mean_c, mean_t = float(dc.mean()), float(dt.mean())
        say("gen", path=dn, vs_f32_activations_max_kernel=f"{max_c:.4e}",
            vs_f32_activations_max_plain=f"{max_t:.4e}", max_margin=BF16_MAX_MARGIN,
            vs_f32_activations_mean_kernel=f"{mean_c:.4e}",
            vs_f32_activations_mean_plain=f"{mean_t:.4e}", mean_margin=BF16_MEAN_MARGIN)
        if max_c > max_t + BF16_MAX_MARGIN or mean_c > mean_t * (1 + BF16_MEAN_MARGIN):
            raise AssertionError(
                f"{dn}: the kernel path is {max_c} (max) / {mean_c} (mean) from the fp32-"
                f"activation logits, the plain path {max_t} / {mean_t}: past the margins"
            )
        del ref
    if speculative:
        launches["spec"] = speculative_check(g, config, backend, dn, kv_quant, prompt, res, lc, per_chunk)
    launches["tokens"] = generated
    g = None
    torch.cuda.empty_cache()
    return launches


SPEC_D = 4  # draft window of the speculative runs


def recorded_forwards(run):
    """``run()`` with the generator module's ``forward`` wrapped: returns its
    result and the (tokens (1, T) tensor, pos) of every forward it made, in
    order (the tokens stay on the device until the run is over)."""
    from llama2_tpu_torch.runtime import generator as gm

    calls = []
    forward = gm.forward

    def record(params, cache, tok, pos, *args):
        calls.append((tok, int(pos)))
        return forward(params, cache, tok, pos, *args)

    gm.forward = record
    try:
        return run(), [(tok[0].tolist(), pos) for tok, pos in calls]
    finally:
        gm.forward = forward


def check_spec_stream(g, config, backend, kv_quant, prompt, res, calls, what: str) -> list[int]:
    """A speculative run's tokens against its own verify windows, bit for
    bit. The recorded forwards (the prefill, then one window a trip) are
    replayed in order through ``backend`` on a fresh cache padded as the
    run's: the rows each reads were written by the same calls, so the replay
    gives the run's logits. Then, independently of the Generator's loop,
    each trip's window must start right after the last committed position
    with the argmax carried from the row before it, and commit the longest
    prefix its own row argmaxes confirm (cut at a BOS and at the budget):
    the tokens so committed must be the run's. Returns the tokens committed
    by each trip."""
    import torch

    from llama2_tpu_torch.models.llama import activation_dtype, forward, init_cache, logits_from_hidden
    from llama2_tpu_torch.ops import sampling
    from llama2_tpu_torch.runtime.generator import BOS

    params = g.params
    dev = params["rms_final"].device
    cache = init_cache(config, 1, activation_dtype(params), dev, kv_quant, pad=SPEC_D)
    P, steps = len(prompt), len(prompt) + GEN_TOKENS
    if not calls or calls[0] != ([BOS] + prompt, 0):
        raise AssertionError(f"{what}: the first forward is not the prompt's prefill")
    argmaxes = []
    for i, (seg, pos) in enumerate(calls):
        h = forward(params, cache, torch.tensor([seg], device=dev), pos, config, backend)
        rows = h[:, -1:, :] if i == 0 else h[0]  # as the Generator takes them
        argmaxes.append(sampling.sample_argmax(logits_from_hidden(params, rows, backend)).reshape(-1).tolist())
    nxt, committed, got, per_trip = argmaxes[0][-1], P, [], []
    for i, ((seg, pos), targets) in enumerate(zip(calls[1:], argmaxes[1:])):
        if pos != committed + 1 or len(seg) != SPEC_D or seg[0] != nxt:
            raise AssertionError(f"{what}: trip {i} runs {seg} at {pos}; want {nxt} first at {committed + 1}")
        acc = 1
        while acc < SPEC_D and seg[acc] == targets[acc - 1]:
            acc += 1
        n = 0
        while n < acc and seg[n] != BOS and committed + n < steps:
            n += 1
        got += seg[:n]
        per_trip.append(n)
        if n < acc and i != len(calls) - 2:
            raise AssertionError(f"{what}: trips ran on after a stop in trip {i}")
        if n:
            nxt, committed = targets[n - 1], committed + n
    if got != res.tokens[P:] or len(per_trip) != res.spec_trips:
        raise AssertionError(f"{what}: the replayed windows commit {got}, the run gave {res.tokens[P:]}")
    return per_trip


def speculative_check(g, config, backend, dn, kv_quant, prompt, plain_res, l1, per_chunk) -> dict:
    """Greedy generation with ``speculative=SPEC_D`` on the same Generator,
    against its plain greedy run ``plain_res``, twice: with the Generator's
    prompt-lookup drafts, then with drafts taken from that first run's own
    stream (its first trip's row 0 sees the same inputs, so at least that
    trip accepts a draft: multi-token acceptance runs on the card). Each trip
    is one forward of SPEC_D tokens (K7 over the int8 cache, K1 over the fp
    cache, the prefill chunk's K6 launches and one K5 for the window's
    logits): launches asserted per trip. Each run's tokens are held to its
    own windows' argmaxes bit for bit (``check_spec_stream``). Against plain
    greedy, the first run's tokens must be equal up to the first position
    whose top-2 logit margin (``l1``: the T = 1 replay of the plain stream) is
    below twice the largest distance between T = 1 and T = SPEC_D logits of
    the same stream, taken over every alignment of the windows."""
    from llama2_tpu_torch.runtime import generator as gm
    from llama2_tpu_torch.runtime.generator import BOS

    L = config.n_layers
    # a verify window runs the prefill chunk's layer: its K6 launches again
    per_trip = {"K7" if kv_quant else "K1": L, "K6": per_chunk["K6"], "K5": 1}
    per_trip.update({k: L for k in ("K1-mma", "K1-tf32") if k in per_chunk and not kv_quant})

    def spec_run(what):
        g.speculative = SPEC_D
        try:
            (res, launches, _), calls = recorded_forwards(lambda: run_counted(g, prompt))
        finally:
            g.speculative = 0
        trips = res.spec_trips
        want = {k: per_chunk.get(k, 0) + trips * per_trip.get(k, 0) for k in launches}
        if launches != want or trips < 1:
            raise AssertionError(f"{what}: launches {launches}, want {want} ({trips} trips)")
        return res, launches, check_spec_stream(g, config, backend, kv_quant, prompt, res, calls, what)

    res, launches, committed = spec_run(f"{dn} spec")
    stream, lookup = res.tokens, gm.prompt_lookup
    gm.prompt_lookup = lambda hist, first, d: [
        stream[len(hist) + 1 + k] if len(hist) + 1 + k < len(stream) else first for k in range(d - 1)]
    try:
        res_self, _, committed_self = spec_run(f"{dn} spec, self drafts")
    finally:
        gm.prompt_lookup = lookup
    if max(committed_self) < 2:
        raise AssertionError(f"{dn} spec: no trip accepted a draft taken from the run's own stream")
    plain = plain_res.tokens[len(prompt):]
    got = res.tokens[len(prompt):]
    n = len(plain)
    stream = [BOS] + plain_res.tokens
    dist = 0.0
    for offset in range(SPEC_D):
        ld = teacher_forced_logits(g.params, config, stream, len(prompt), backend, kv_quant,
                                   window=SPEC_D, offset=offset)
        dist = max(dist, float((ld - l1).abs().max()))
    top2 = l1[:n].topk(2, dim=-1).values
    narrow = ((top2[:, 0] - top2[:, 1]) <= 2 * dist).tolist()
    covered = narrow.index(True) if True in narrow else n
    if got[:covered] != plain[:covered]:
        raise AssertionError(f"{dn} spec: tokens differ from plain greedy within the first "
                             f"{covered} positions (clear margins): {got[:covered]} != {plain[:covered]}")
    decode_s = res.total_s - res.ttft_s
    self_s = res_self.total_s - res_self.ttft_s
    say("spec", path=dn, d=SPEC_D, trips=res.spec_trips, generated=len(got),
        accepted_per_trip=f"{len(got) / res.spec_trips:.3f}",
        per_trip=",".join(f"{k}={v}" for k, v in per_trip.items()),
        **{f"{k}_launches": v for k, v in launches.items() if v})
    say("spec", path=dn, decode_tok_s=f"{len(got) / decode_s:.2f}",
        plain_decode_tok_s=f"{n / (plain_res.total_s - plain_res.ttft_s):.2f}",
        ttft_ms=f"{res.ttft_s * 1e3:.2f}", logit_dist_T1_vs_Td=f"{dist:.3e}",
        positions_covered_by_margin=f"{covered}/{n}",
        tokens_equal_to_plain=f"{sum(a == b for a, b in zip(got, plain))}/{n}",
        tokens_equal_to_own_windows_argmax="all")
    say("spec", path=dn, drafts="own_stream", trips=res_self.spec_trips,
        accepted_per_trip=f"{sum(committed_self) / res_self.spec_trips:.3f}",
        trips_accepting_a_draft=sum(c > 1 for c in committed_self),
        committed_by_trip=",".join(map(str, committed_self)),
        decode_tok_s=f"{sum(committed_self) / self_s:.2f}", tokens_equal_to_own_windows_argmax="all")
    return launches


# ---------------------------------------------------------------- phase 3, served


SERVE_REQUESTS = 16
SERVE_SLOTS = 8
SERVE_PAGE = 256
SYSTEM_TOKENS = 256
LONG_SUFFIX = 200  # request 2's suffix after the shared prefix: a hit with a suffix past 128 tokens
SAMPLED = (3, 6, 9, 12)  # the workload's sampled requests; the other 12 are greedy


def serve_workload() -> list:
    """The served path's SERVE_REQUESTS requests, from a seed: (prompt,
    GenerationConfig). Prompts of 16-600 tokens, 64-128 new tokens each; the
    SAMPLED requests at temperature 0.8, top-p 0.9, seeded, the rest greedy;
    the even requests share one 256-token system prefix (request 2 with a
    suffix of LONG_SUFFIX tokens)."""
    import numpy as np

    from llama2_tpu_torch.config import GenerationConfig

    rng = np.random.default_rng(SEED + 20)

    def toks(n):
        return rng.integers(2, 32000, n).tolist()

    system = toks(SYSTEM_TOKENS)
    out = []
    for i in range(SERVE_REQUESTS):
        if i % 2 == 0:
            prompt = system + toks(LONG_SUFFIX if i == 2 else int(rng.integers(16, 600 - SYSTEM_TOKENS + 1)))
        else:
            prompt = toks(int(rng.integers(16, 601)))
        sampled = i in SAMPLED
        steps = len(prompt) + int(rng.integers(64, 129))
        out.append((prompt, GenerationConfig(temperature=0.8 if sampled else 0.0, top_p=0.9, steps=steps,
                                             seed=SEED + i if sampled else None)))
    return out


# launches per decode tick of the served paths at L layers (a kernel not
# named launches 0 times): on `cuda` the two-launch paged layer (glue-fused
# paged attention + the wo/FFN/next-QKV megakernel); on `cuda-accurate` the
# composed layer; the dense engine at 8 rows: the whole-layer kernel over
# the int8 cache, the two-launch layer over the fp cache. A tick runs all 8
# slots, so every megakernel launch of a tick takes the tensor-core form.
SERVE_TICKS = {
    ("cuda", False): lambda L: {"K6": 1, "K17": L, "K12": L - 1, "K11": 1, "K5": 1,
                                "K12-mma": L - 1, "K11-mma": 1},
    ("cuda", True): lambda L: {"K6": 1, "K18": L, "K12": L - 1, "K11": 1, "K5": 1,
                               "K12-mma": L - 1, "K11-mma": 1},
    ("cuda-accurate", False): lambda L: {"K6": 4 * L, "K15": L, "K5": 1},
    ("cuda-accurate", True): lambda L: {"K6": 4 * L, "K16": L, "K5": 1},
    ("dense", False): lambda L: {"K6": 1, "K4": L, "K12": L - 1, "K11": 1, "K5": 1,
                                 "K12-mma": L - 1, "K11-mma": 1},
    ("dense", True): lambda L: {"K6": 1, "K13": L, "K5": 1, "K13-mma": L},
}


def served_run(eng, reqs, log: bool = False) -> dict:
    """Serve ``reqs`` on ``eng``, all submitted at once and driven to idle,
    with every launch counter set to 0 just before and read just after; each
    decode window's launches recorded apart (admission prefills launch too).
    With ``log``, every sampled logits row is kept, per request in order:
    its first token's, then one a tick it was seated in (meant for
    ticks_per_sync 1 and pipeline depth 1, where each such row gives the
    request's next token)."""
    import torch

    wrappers = count_launches()
    ticks, admit_s = [], [0.0]
    rows: dict = {}
    dispatch, start, sample, sample_first = (
        eng._dispatch_tick, eng._start_request, eng._sample, eng._sample_first)

    def counted_dispatch(active):
        before = {k: w.launches for k, w in wrappers.items()}
        dispatch(active)
        ticks.append({k: w.launches - before[k] for k, w in wrappers.items()})

    def timed_start(slot, req):
        t0 = time.perf_counter()
        start(slot, req)
        admit_s[0] += time.perf_counter() - t0

    def logged_sample(logits, sampled, draws):
        for b, r in enumerate(eng.slots):
            if r is not None:
                rows.setdefault(id(r), []).append(logits[b].detach().float().clone())
        return sample(logits, sampled, draws)

    def logged_first(logits, req, pos):
        rows[id(req)] = [logits.detach().float().clone()]
        return sample_first(logits, req, pos)

    eng._dispatch_tick, eng._start_request = counted_dispatch, timed_start
    if log:
        eng._sample, eng._sample_first = logged_sample, logged_first
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        queues = [eng.submit(p, g) for p, g in reqs]
        submitted = list(eng.waiting.queue)  # the Request objects, in order
        eng.run_until_idle()
        results = [q.get(timeout=600) for q in queues]
        torch.cuda.synchronize()
    finally:
        for name in ("_dispatch_tick", "_start_request", "_sample", "_sample_first"):
            eng.__dict__.pop(name, None)
    wall = time.perf_counter() - t0
    for r in results:
        if isinstance(r, Exception):
            raise AssertionError(f"a served request failed: {r!r}")
    return {
        "launches": {k: w.launches for k, w in wrappers.items()}, "ticks": ticks, "wall_s": wall,
        "admit_s": admit_s[0], "peak": torch.cuda.max_memory_allocated(),
        "tokens": [r.tokens for r in results], "results": results,
        "logits": [torch.stack(rows[id(r)]).cpu() for r in submitted] if log else None,
    }


def assert_ticks(run: dict, per_tick: dict, dn: str) -> int:
    """Every decode window (ticks_per_sync 1) launched exactly ``per_tick``."""
    want = {k: per_tick.get(k, 0) for k in run["launches"]}
    bad = [t for t in run["ticks"] if t != want]
    if not run["ticks"] or bad:
        raise AssertionError(f"{dn}: launches per decode tick {bad[:1]}, want {want}")
    return len(run["ticks"])


def forced_replay(config, params, reqs, streams: list, backend: str, **engine) -> list:
    """``streams`` (each request's served tokens) teacher-forced through a
    paged engine on ``backend`` with the settings ``engine``, whose samplers
    return each request's served tokens instead of sampling. Returns each
    request's logits rows, as a logged run keeps them. Requests are told
    apart by their prompts."""
    import torch

    from llama2_tpu_torch.runtime.generator import BOS
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

    eng = PagedBatchEngine(config, params, backend=backend, device="cuda", pipeline_depth=1, **engine)
    served = {tuple(p): toks for (p, _), toks in zip(reqs, streams)}
    rows: dict = {}

    def forced(req, n):
        toks = served[tuple(req.prompt)]
        return toks[n] if n < len(toks) else BOS

    def sample(logits, sampled, draws):
        nxt = []
        for b, r in enumerate(eng.slots):
            if r is not None:
                rows[id(r)].append(logits[b].float().cpu())
            nxt.append(0 if r is None else forced(r, len(r.tokens)))
        return torch.tensor(nxt, dtype=torch.int32, device=logits.device)

    def sample_first(logits, req, pos):
        rows[id(req)] = [logits.float().cpu()]
        return forced(req, len(req.prompt))

    eng._sample, eng._sample_first = sample, sample_first
    queues = [eng.submit(p, g) for p, g in reqs]
    submitted = list(eng.waiting.queue)
    eng.run_until_idle()
    if [q.get(timeout=600).tokens for q in queues] != list(streams):
        raise AssertionError("the forced replay did not follow the served streams")
    return [torch.stack(rows[id(r)]) for r in submitted]


def check_served_tokens(params, config, reqs, run: dict, kv_quant: bool, dtype, dn: str, rule: str) -> None:
    """Each greedy stream of a logged run against its teacher-forced replay
    through the plain path: the same paged engine (8 slots, 256-row pages,
    the prefix cache, so the same admissions, prefix hits and
    fp-prefill-then-quantize rows) on ``backend="torch"``. The distance is the largest
    |engine logits - plain logits| over every greedy stream (PERF.md section
    2): ``rule="margin"``: each token equals the plain argmax wherever the
    plain top-2 margin exceeds twice it; ``"fp32-int8"``: that, and the
    distance within F32_FAST_LOGIT_RTOL of the largest logit; ``"exact"``
    (fp32 over an fp pool): every token, and the distance within
    F32_LOGIT_ATOL."""
    import torch

    plain = forced_replay(config, params, reqs, run["tokens"], "torch", batch_size=SERVE_SLOTS,
                          page_size=SERVE_PAGE, prefix_cache=True, dtype=dtype, kv_quant=kv_quant)
    dist, absmax, pairs = 0.0, 0.0, []
    for (prompt, gen), toks, lk, lp in zip(reqs, run["tokens"], run["logits"], plain):
        if gen.temperature != 0.0:
            continue
        generated = toks[len(prompt):]
        n = len(generated)
        if lk[:n].argmax(-1).tolist() != generated or lp.shape != lk.shape:
            raise AssertionError(f"{dn}: a served stream is not the argmax of its own logits")
        dist = max(dist, float((lk - lp).abs().max()))
        absmax = max(absmax, float(lp.abs().max()))
        pairs.append((generated, lp[:n]))
    checked = agree = total = 0
    for generated, lp in pairs:
        top2 = lp.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * dist
        if rule == "exact":
            clear[:] = True
        ok = lp.argmax(-1) == torch.tensor(generated)
        checked, agree, total = checked + int(clear.sum()), agree + int(ok[clear].sum()), total + len(generated)
        if not bool(ok[clear].all()):
            raise AssertionError(f"{dn}: a served token differs from the plain replay where it must not")
    if (rule == "exact" and dist > F32_LOGIT_ATOL) or (rule == "fp32-int8" and dist > F32_FAST_LOGIT_RTOL * absmax):
        raise AssertionError(f"{dn}: served logits {dist} from the plain path, past the {rule} bound")
    say("serve", path=dn, greedy_streams=len(pairs), logit_max_abs_diff_vs_plain=f"{dist:.3e}",
        logit_absmax=f"{absmax:.3f}", rule=rule, tokens_checked=f"{checked}/{total}",
        equal_to_plain_there=f"{agree}/{checked}")


def seat_long(eng, pos0: int) -> None:
    """Seat a greedy request in every slot of ``eng`` at position pos0 over
    pages of random contents (as if prefilled); each then runs to the end of
    the context, S - pos0 ticks."""
    import queue

    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.runtime.batch_engine import Request

    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    for name in ("k", "v", "ks", "vs"):
        t = getattr(eng.pool, name)
        if t is None:
            continue
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, device="cuda", dtype=torch.int8))
        elif name in ("ks", "vs"):
            t.copy_(0.02 + 0.01 * torch.rand(t.shape, generator=g, device="cuda"))
        else:
            t.normal_(generator=g)
    for b in range(eng.batch_size):
        req = Request(prompt=[5] * (pos0 - 1), gen=GenerationConfig(temperature=0.0, steps=S),
                      result_q=queue.Queue())
        req.tokens, req.steps, req.ttft_s, req.admitted_at = [5] * pos0, S, 0.0, req.submitted_at
        pages = eng._alloc(pos0 // eng.page_size + 1)
        eng._slot_pages[b] = pages
        eng._tables[b, : len(pages)] = pages
        eng.slots[b] = req
        eng._tokens[b], eng._pos[b], eng._argmax[b] = 5, pos0, True


def profile_ticks(eng, dn: str, where: str, n: int = 16) -> None:
    """``profile_steps`` over ``n`` decode ticks of the seated slots."""
    import torch

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            eng._step()
        eng._drain(0)
        torch.cuda.synchronize()
        return n, time.perf_counter() - t0

    profile_steps(dn, where, run)


def tick_profiles(config, params, kw: dict, dn: str) -> None:
    """Device and host time a tick of ``PagedBatchEngine(config, params,
    **kw)``: 16 ticks of 8 slots seated on 16-token prompts (pos 17-32), and
    16 seated at pos 4080 (``seat_long``: pos 4080-4095)."""
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

    eng = PagedBatchEngine(config, params, page_size=SERVE_PAGE, prefix_cache=True, **kw)
    for p, _ in serve_workload()[:SERVE_SLOTS]:
        eng.submit(p[:16], GenerationConfig(temperature=0.0, steps=16 + 40))
    eng._admit()
    profile_ticks(eng, dn, "pos_17_to_32")
    eng._fail_all(RuntimeError("profile done"))
    eng = None
    torch.cuda.empty_cache()
    eng = PagedBatchEngine(config, params, page_size=SERVE_PAGE,
                           n_pages=SERVE_SLOTS * (S // SERVE_PAGE) + 1, **kw)
    seat_long(eng, S - 16)
    profile_ticks(eng, dn, f"pos_{S - 16}_to_{S - 1}")
    eng = None
    torch.cuda.empty_cache()


def phase_serve_timing() -> None:
    """The served bf16-pool tick alone, for comparing two trees in one call:
    ``python3 chip_smoke.py --serve-timing`` runs it and nothing else. The
    path of ``phase_serve(False)``: one warm-up, one timed serving of
    serve_workload() (the launches of every tick asserted; served and decode
    tok/s), then ``tick_profiles``. It reaches the engine through its own
    helpers and the engine's API only, so a copy of this script times an
    older checkout from that checkout's root."""
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io.convert import random_q8_params
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

    config = config_7b(32)
    dn = f"q8/bf16/cuda/paged-bf16-pool/{config.n_layers}L"
    params = random_q8_params(config, SEED, "cuda", torch.bfloat16, group_size=GROUP)
    kw = dict(batch_size=SERVE_SLOTS, dtype=torch.bfloat16, backend="cuda", device="cuda", kv_quant=False)
    reqs = serve_workload()
    eng = PagedBatchEngine(config, params, page_size=SERVE_PAGE, prefix_cache=True, **kw)
    params = eng.params
    served_run(eng, [(p[:40], GenerationConfig(temperature=0.0, steps=48)) for p, _ in reqs[:SERVE_SLOTS]])
    eng = PagedBatchEngine(config, params, page_size=SERVE_PAGE, prefix_cache=True, **kw)
    timed = served_run(eng, reqs)
    assert_ticks(timed, SERVE_TICKS[("cuda", False)](config.n_layers), dn)
    n_tok = sum(len(t) - len(p) for t, (p, _) in zip(timed["tokens"], reqs))
    say("serve", path=dn, served_tok_s=f"{n_tok / timed['wall_s']:.2f}",
        decode_tok_s=f"{eng.metrics['tokens'] / (timed['wall_s'] - timed['admit_s']):.2f}")
    eng = None
    torch.cuda.empty_cache()
    tick_profiles(config, params, kw, dn)


def phase_serve(kv_quant: bool) -> dict:
    """This slice's main path: ``PagedBatchEngine`` at full Llama-2-7B width,
    32 layers, INT8 weights, bf16 activations, backend ``cuda``, 8 slots,
    256-row pages, the prefix cache on, over a bf16 or an int8 pool, serving
    serve_workload(). Three runs on fresh engines (the prefix cache starts
    empty each time): timed, at pipeline depth 2; at depth 1 with every
    logits row kept; at depth 2 again. Asserted: the launches of every decode
    tick (SERVE_TICKS); the three runs' tokens equal; a prefix hit (request 2
    hits with a suffix past 128 tokens); each greedy stream against its plain
    replay (``check_served_tokens``). Printed: served and decode tok/s, TTFT
    p50/p95 with queue wait and prefill apart, device and host ms a tick at
    positions 17-32 and 4080-4095 (profiled), and peak memory against the
    dense ``BatchEngine`` on the same requests. Returns the timed run's
    launches, and the dense engine's under "dense-" names."""
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io.convert import random_q8_params
    from llama2_tpu_torch.runtime.batch_engine import BatchEngine
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

    config = config_7b(32)
    L = config.n_layers
    dn = f"q8/bf16/cuda/paged-{'int8' if kv_quant else 'bf16'}-pool/{L}L"
    t0 = time.perf_counter()
    params = random_q8_params(config, SEED, "cuda", torch.bfloat16, group_size=GROUP)
    torch.cuda.synchronize()
    say("serve", path=dn, params_built_s=f"{time.perf_counter() - t0:.1f}")
    kw = dict(batch_size=SERVE_SLOTS, dtype=torch.bfloat16, backend="cuda", device="cuda",
              kv_quant=kv_quant)

    def engine(**extra):
        eng = PagedBatchEngine(config, params, page_size=SERVE_PAGE, prefix_cache=True, **kw, **extra)
        return eng

    reqs = serve_workload()
    eng = engine()
    params = eng.params  # fused once; the later engines take the same tensors
    # warm-up: kernels loaded, workspaces and the allocator's pools grown
    served_run(eng, [(p[:40], GenerationConfig(temperature=0.0, steps=48)) for p, _ in reqs[:SERVE_SLOTS]])
    eng = None
    torch.cuda.empty_cache()

    eng = engine()
    timed = served_run(eng, reqs)
    per_tick = SERVE_TICKS[("cuda", kv_quant)](L)
    n_ticks = assert_ticks(timed, per_tick, dn)
    k1 = timed["launches"]
    if k1["K1"] < L or k1["K1-mma"] != k1["K1"]:  # admission prefills over the bf16 staging plane
        raise AssertionError(f"{dn}: K1 launched {k1['K1']} times, {k1['K1-mma']} of them "
                             "through the tensor-core variant; want all, at least one chunk")
    hits = eng.metrics["prefix_hit_pages"]
    if hits < 1:
        raise AssertionError(f"{dn}: no prefix-cache hit")
    pool_bytes = sum(t.nbytes for t in eng.pool.tensors)
    pct = eng.ttft_percentiles()
    n_tok = sum(len(t) - len(p) for t, (p, _) in zip(timed["tokens"], reqs))
    say("serve", path=dn, requests=len(reqs), slots=SERVE_SLOTS, page=SERVE_PAGE, pool_pages=eng.pool.n_pages,
        decode_ticks=n_ticks, per_tick=",".join(f"{k}={v}" for k, v in per_tick.items()),
        prefix_hit_pages=hits, **{f"{k}_launches": v for k, v in timed["launches"].items() if v})
    say("serve", path=dn, generated=n_tok, wall_s=f"{timed['wall_s']:.3f}",
        served_tok_s=f"{n_tok / timed['wall_s']:.2f}",
        decode_tok_s=f"{eng.metrics['tokens'] / (timed['wall_s'] - timed['admit_s']):.2f}",
        admission_s=f"{timed['admit_s']:.3f}",
        ttft_p50_ms=f"{pct['p50'] * 1e3:.2f}", ttft_p95_ms=f"{pct['p95'] * 1e3:.2f}",
        queue_wait_p50_ms=f"{pct['queue_wait_p50'] * 1e3:.2f}",
        queue_wait_p95_ms=f"{pct['queue_wait_p95'] * 1e3:.2f}",
        prefill_p50_ms=f"{pct['prefill_p50'] * 1e3:.2f}", prefill_p95_ms=f"{pct['prefill_p95'] * 1e3:.2f}",
        pool_GiB=f"{pool_bytes / 2**30:.2f}", peak_mem_GiB=f"{timed['peak'] / 2**30:.2f}")
    eng = None
    torch.cuda.empty_cache()

    logged = served_run(engine(pipeline_depth=1), reqs, log=True)
    torch.cuda.empty_cache()
    again = served_run(engine(), reqs)
    torch.cuda.empty_cache()
    if not logged["tokens"] == timed["tokens"] == again["tokens"]:
        raise AssertionError(f"{dn}: a rerun, or pipeline depth 1, gave other tokens")
    say("serve", path=dn, rerun="tokens_equal", pipeline_depth_1_vs_2="tokens_equal")
    check_served_tokens(params, config, reqs, logged, kv_quant, torch.bfloat16, dn, "margin")
    logged = again = None

    tick_profiles(config, params, kw, dn)

    # the dense engine on the same requests: 8 slots of seq_len rows
    dense = BatchEngine(config, params, **kw)
    served_run(dense, [(p[:40], GenerationConfig(temperature=0.0, steps=48)) for p, _ in reqs[:SERVE_SLOTS]])
    run = served_run(dense, reqs)
    assert_ticks(run, SERVE_TICKS[("dense", kv_quant)](L), f"{dn} dense")
    cache_bytes = sum(t.nbytes for t in dense.cache.values())
    same = sum(a == b for x, y in zip(run["tokens"], timed["tokens"]) for a, b in zip(x, y))
    say("serve", path=f"q8/bf16/cuda/dense-{'int8' if kv_quant else 'bf16'}-cache/{L}L",
        per_tick=",".join(f"{k}={v}" for k, v in SERVE_TICKS[("dense", kv_quant)](L).items()),
        served_tok_s=f"{n_tok / run['wall_s']:.2f}", cache_GiB=f"{cache_bytes / 2**30:.2f}",
        peak_mem_GiB=f"{run['peak'] / 2**30:.2f}", paged_peak_mem_GiB=f"{timed['peak'] / 2**30:.2f}",
        tokens_equal_to_paged=f"{same}/{sum(len(t) for t in timed['tokens'])}")
    dense = None
    params = None
    torch.cuda.empty_cache()
    return {**timed["launches"], **{f"dense-{k}": v for k, v in run["launches"].items()}}


def phase_serve_accurate(kv_quant: bool) -> dict:
    """``cuda-accurate`` in fp32 at 8 layers, the paged engine over an fp32 or
    an int8 pool (the composed layer: K6 four a layer, K15 or K16 one a
    layer, K5): launches per tick asserted, and the greedy streams of a
    logged run held to the plain path by the fp32 rules of PERF.md section 2
    (fp pool: every token, logits within F32_LOGIT_ATOL; int8 pool: within
    F32_FAST_LOGIT_RTOL of the largest logit, tokens where the margin is
    clear). Returns the launches."""
    import torch

    from llama2_tpu_torch.io.convert import random_q8_params
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

    config = config_7b(8)
    L = config.n_layers
    dn = f"q8/f32/cuda-accurate/paged-{'int8' if kv_quant else 'f32'}-pool/{L}L"
    params = random_q8_params(config, SEED, "cuda", torch.float32, group_size=GROUP)
    eng = PagedBatchEngine(config, params, batch_size=SERVE_SLOTS, page_size=SERVE_PAGE, prefix_cache=True,
                           dtype=torch.float32, backend="cuda-accurate", device="cuda", kv_quant=kv_quant,
                           pipeline_depth=1)
    reqs = serve_workload()
    run = served_run(eng, reqs, log=True)
    per_tick = SERVE_TICKS[("cuda-accurate", kv_quant)](L)
    n_ticks = assert_ticks(run, per_tick, dn)
    if run["launches"]["K1-tf32"] != run["launches"]["K1"]:  # fp32: the TF32 variant only
        raise AssertionError(f"{dn}: fp32 K1 launched {run['launches']['K1']} times, "
                             f"{run['launches']['K1-tf32']} of them as tf32")
    if run["launches"]["K6-tile-acc"] == 0:  # admission chunks past 8 tokens
        raise AssertionError(f"{dn}: no admission prefill took the accurate M > 8 tile")
    say("serve", path=dn, decode_ticks=n_ticks, per_tick=",".join(f"{k}={v}" for k, v in per_tick.items()),
        served_tok_s=f"{sum(len(t) - len(p) for t, (p, _) in zip(run['tokens'], reqs)) / run['wall_s']:.2f}",
        **{f"{k}_launches": v for k, v in run["launches"].items() if v})
    check_served_tokens(eng.params, config, reqs, run, kv_quant, torch.float32, dn,
                        "fp32-int8" if kv_quant else "exact")
    eng = params = None
    torch.cuda.empty_cache()
    return run["launches"]


# ---------------------------------------------------------------- phase 4


CLI_PROMPT = "Once upon a time"


def run_cli(path: str, *extra: str) -> tuple[bytes, str]:
    """``python -m llama2_tpu_torch`` on ``path``: (stdout, a report line)."""
    import torch

    cmd = [
        sys.executable, "-m", "llama2_tpu_torch", path, "-t", "0", "-n", "64",
        "-i", CLI_PROMPT, "-z", TOKENIZER_BIN, "-v", *extra,
    ]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, timeout=600, cwd=REPO)
    secs = time.perf_counter() - t0
    err = r.stderr.decode(errors="replace")
    if r.returncode != 0:
        raise AssertionError(f"CLI exited {r.returncode}:\n{err}")
    tps = [line for line in err.splitlines() if "tokens per second" in line]
    if torch.cuda.get_device_name(0) not in err or not tps or not r.stdout:
        raise AssertionError(f"CLI output lacks the device name or a tokens/s line:\n{err}")
    say("cli", args="_".join(a for a in extra if os.sep not in a) or "none",
        checkpoint="directory" if os.path.isdir(path) else f"{os.path.getsize(path) / 1e9:.2f}_GB",
        rc=r.returncode, seconds=f"{secs:.1f}", stdout_bytes=len(r.stdout),
        report=tps[0].strip().replace(" ", "_"))
    return r.stdout, err


def generate_bytes(path: str, spec: int) -> bytes:
    """What the CLI prints for ``path`` with ``--kernels cuda --dtype bf16
    --kv-cache int8 [--spec spec] -t 0 -n 64``, through ``Generator.generate``
    in this process. The prompt is at most 16 tokens, so its prefill chunk
    attends through the int8 window kernel (K7), asserted here, and the
    decode steps through the whole-layer kernel (K13)."""
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io import load_any
    from llama2_tpu_torch.runtime.generator import Generator
    from llama2_tpu_torch.tokenizer.tokenizer import BOS, Tokenizer

    config, params, _ = load_any(path)
    tok = Tokenizer.from_file(TOKENIZER_BIN, config.vocab_size)
    prompt = tok.encode(CLI_PROMPT)
    g = Generator(config, params, dtype=torch.bfloat16, backend="cuda", device="cuda", kv_quant=True,
                  speculative=spec)
    wrappers = count_launches()
    for w in wrappers.values():
        w.launches = 0
    res = g.generate(prompt, GenerationConfig(temperature=0.0, steps=64))
    k7, k13 = wrappers["K7"].launches, wrappers["K13"].launches
    if len(prompt) + 1 > 16 or k7 < config.n_layers or (not spec and k13 < config.n_layers):
        raise AssertionError(f"prompt of {len(prompt)} tokens: K7 {k7}, K13 {k13} launches")
    say("cli", generate="in_process", kv_cache="int8", spec=spec, prompt_tokens=len(prompt),
        K7_launches=k7, K13_launches=k13, spec_trips=res.spec_trips)
    return tok.decode(res.tokens, first_prev=BOS)


SERVER_PROMPTS = ("Once upon a time", "The little dog ran", "She opened the door")


def hold_server_streams(path: str, results: dict) -> dict:
    """The server's greedy answers (``results[i]`` for ``SERVER_PROMPTS[i]``)
    on the checkpoint at ``path``. Each answer's tokens start with its prompt
    and its text decodes them. Exact: the tokens equal, token for token,
    those of an in-process paged engine with the server's settings (8 slots,
    256-row pages, no prefix cache, fp32 activations, fast mode: K17 a decode
    layer, K4 for one-token admission chunks, K12 at up to 8 rows) run free
    on the same prompts. Across routes: ``Generator.generate``'s dense single
    stream (K4's split form at one row) sums attention in another order than
    K17, and fast mode rounds every matmul operand to bf16, so a greedy
    near-tie may flip. Each served stream is teacher-forced through both
    routes; wherever the Generator route's top-2 margin exceeds twice the
    routes' largest logit distance, the served token is its argmax, and the
    distance stays within phase 3's fast-mode bar. Returns what to report."""
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io import load_any
    from llama2_tpu_torch.quant.q8 import quantize_params
    from llama2_tpu_torch.runtime.generator import BOS, Generator
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine
    from llama2_tpu_torch.tokenizer.tokenizer import Tokenizer

    config, params, _ = load_any(path)
    params = quantize_params(params)
    tok = Tokenizer.from_file(TOKENIZER_BIN, config.vocab_size)
    greedy = GenerationConfig(temperature=0.0, steps=48)
    reqs = [(tok.encode(prompt), greedy) for prompt in SERVER_PROMPTS]
    served = [results[i]["tokens"] for i in range(len(SERVER_PROMPTS))]
    for i, ((prompt, _), toks) in enumerate(zip(reqs, served)):
        if toks[: len(prompt)] != prompt or results[i]["text"] != tok.decode(toks).decode("utf-8", "replace"):
            raise AssertionError(f"served answer for {SERVER_PROMPTS[i]!r} malformed: {results[i]}")
    # the server's engine settings (runtime/server.py with --quant int8 --paged --kernels cuda --dtype f32)
    settings = dict(batch_size=8, page_size=256, n_pages=None, prefix_cache=False, dtype=torch.float32,
                    kv_quant=False)
    eng = PagedBatchEngine(config, params, backend="cuda", device="cuda", ticks_per_sync=1, pipeline_depth=2,
                           **settings)
    queues = [eng.submit(prompt, gen) for prompt, gen in reqs]
    eng.run_until_idle()
    in_process = [q.get(timeout=600).tokens for q in queues]
    del eng
    for prompt, toks, want in zip(SERVER_PROMPTS, served, in_process):
        if toks != want:
            raise AssertionError(f"served tokens for {prompt!r} differ from the in-process paged engine's")
    g = Generator(config, params, dtype=torch.float32, backend="cuda", device="cuda")
    wants = [g.generate(prompt, greedy).tokens for prompt, _ in reqs]
    engine_logits = forced_replay(config, params, reqs, served, "cuda", **settings)
    dist, absmax, pairs = 0.0, 0.0, []
    for (prompt, _), toks, le in zip(reqs, served, engine_logits):
        generated = toks[len(prompt):]
        n = len(generated)
        lg = teacher_forced_logits(g.params, config, [BOS] + toks, len(prompt), "cuda")[:n]
        dist = max(dist, float((le[:n] - lg).abs().max()))
        absmax = max(absmax, float(lg.abs().max()))
        pairs.append((generated, lg))
    checked = 0
    for generated, lg in pairs:
        top2 = lg.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * dist
        checked += int(clear.sum())
        if not bool((lg.argmax(-1) == torch.tensor(generated))[clear].all()):
            raise AssertionError("a served token differs from the Generator route's at a clear margin")
    if dist > F32_FAST_LOGIT_RTOL * absmax:
        raise AssertionError(f"the server's route is {dist} from the Generator's "
                             f"(bound {F32_FAST_LOGIT_RTOL * absmax})")
    equal = sum(a == b for s, w in zip(served, wants) for a, b in zip(s, w))
    return {"tokens_equal_to_in_process_engine": "all",
            "logit_max_abs_diff_vs_generator_route": f"{dist:.3e}", "logit_absmax": f"{absmax:.3f}",
            "tokens_checked": f"{checked}/{sum(len(t) for t, _ in pairs)}",
            "tokens_equal_to_generator": f"{equal}/{sum(len(w) for w in wants)}"}


def phase_server(path: str) -> None:
    """The HTTP server on the 2-layer checkpoint at ``path``, as a user
    starts it: ``python -m llama2_tpu_torch.runtime.server <path> --quant int8
    --paged --kernels cuda --dtype f32 --port 0``. Three concurrent greedy
    requests must return the tokens of an in-process paged engine with the
    server's settings, and are held to ``Generator.generate`` on the same
    prompts by the margin rule (fp32 activations, 2 layers;
    ``hold_server_streams``), one sampled request
    returns its budget; /health and /metrics answer; SIGINT stops it with
    exit 0."""
    import signal
    import threading
    import urllib.request

    cmd = [sys.executable, "-m", "llama2_tpu_torch.runtime.server", path, "-z", TOKENIZER_BIN,
           "--quant", "int8", "--paged", "--kernels", "cuda", "--dtype", "f32", "--port", "0"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stderr=subprocess.PIPE, text=True)
    killer = threading.Timer(600, proc.kill)  # a server that never comes up is killed
    killer.start()
    try:
        lines = []
        for line in proc.stderr:
            lines.append(line)
            if "serving on http://" in line:
                break
        url = next((w for w in lines[-1].split() if w.startswith("http://")), None) if lines else None
        if url is None:
            raise AssertionError("the server printed no address:\n" + "".join(lines))
        up_s = time.perf_counter() - t0

        def post(body):
            req = urllib.request.Request(url + "/generate", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                return json.loads(r.read())

        results = {}
        bodies = [{"prompt": p, "temperature": 0.0, "steps": 48} for p in SERVER_PROMPTS]
        bodies.append({"prompt": SERVER_PROMPTS[0], "temperature": 0.8, "top_p": 0.9, "steps": 48, "seed": 7})
        threads = [threading.Thread(target=lambda i=i, b=b: results.__setitem__(i, post(b)))
                   for i, b in enumerate(bodies)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if len(results) != len(bodies):
            raise AssertionError(f"the server answered {len(results)} of {len(bodies)} requests")
        with urllib.request.urlopen(url + "/health", timeout=30) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=120)
        finally:
            killer.cancel()
            if proc.poll() is None:
                proc.kill()
            proc.stderr.close()
    if rc != 0:
        raise AssertionError(f"the server exited {rc} on SIGINT")
    held = hold_server_streams(path, results)
    sampled = results[len(SERVER_PROMPTS)]["tokens"]
    if not 1 <= len(sampled) <= 48 or health.get("status") != "ok" or metrics.get("requests", 0) < len(bodies):
        raise AssertionError(f"server answers malformed: {sampled}, {health}, {metrics}")
    say("server", args="--quant_int8_--paged_--kernels_cuda_--dtype_f32", up_s=f"{up_s:.1f}",
        greedy_requests=len(SERVER_PROMPTS), **held, sampled_tokens=len(sampled),
        health=health["status"], metrics_requests=metrics["requests"],
        ttft_p50_ms=f"{metrics['ttft_p50_ms']:.2f}", sigint_exit=rc)


def phase_cli() -> None:
    """The CLI on a v0 fp32 checkpoint at 7B width with 2 layers; the same
    file quantized on load (``--quant int8``); the ak42 INT8 file that
    ``python -m llama2_tpu_torch.quant.convert`` writes from it; and the
    param-cache directory that ``--save-cache`` writes from that, which must
    print the same bytes."""
    import shutil

    import torch

    from llama2_tpu_torch.io.checkpoint import save_checkpoint
    from llama2_tpu_torch.io.convert import random_params

    config = config_7b(n_layers=2)
    params = random_params(config, SEED + 1, "cuda", torch.float32)
    params = {k: v.cpu().numpy() for k, v in params.items() if k != "wcls"}
    path = os.path.join(REPO, "build", "smoke", "llama2_7b_width_2_layers.bin")
    q8_path = os.path.join(REPO, "build", "smoke", "llama2_7b_width_2_layers-q8.bin")
    cache_dir = os.path.join(REPO, "build", "smoke", "llama2_7b_width_2_layers-q8-cache")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        save_checkpoint(path, config, params, shared_weights=True)
        del params
        run_cli(path)
        run_cli(path, "--quant", "int8", "--kernels", "cuda-accurate")
        r = subprocess.run(
            [sys.executable, "-m", "llama2_tpu_torch.quant.convert", path, q8_path],
            capture_output=True, timeout=600, cwd=REPO,
        )
        if r.returncode != 0 or not os.path.exists(q8_path):
            raise AssertionError(f"convert exited {r.returncode}:\n{r.stderr.decode(errors='replace')}")
        out, err = run_cli(q8_path, "--kernels", "cuda", "--dtype", "bf16", "--save-cache", cache_dir)
        if "quant: none" not in err:  # the file is INT8 already; no flag needed
            raise AssertionError(f"unexpected CLI log:\n{err}")
        if not os.path.exists(os.path.join(cache_dir, "meta.json")):
            raise AssertionError("--save-cache wrote no param cache")
        out2, _ = run_cli(cache_dir, "--kernels", "cuda", "--dtype", "bf16")
        if out2 != out:
            raise AssertionError("the param-cache directory gives other bytes than the file it was saved from")
        for spec in (0, 4):
            extra = ("--kv-cache", "int8") + (("--spec", str(spec)) if spec else ())
            out_kv, _ = run_cli(q8_path, "--kernels", "cuda", "--dtype", "bf16", *extra)
            if out_kv != generate_bytes(q8_path, spec):
                raise AssertionError(f"the CLI with {' '.join(extra)} prints other bytes than Generator.generate")
        phase_server(path)
    finally:
        for f in (path, q8_path):
            if os.path.exists(f):
                os.remove(f)
        shutil.rmtree(cache_dir, ignore_errors=True)


# ---------------------------------------------------------------- phase 5


def phase_timing(dtype, launches: dict, cycles_per_ms: float) -> list[dict]:
    """Each kernel at the main path's 7B shapes. The caches hold all 32
    layers and call i uses layer i % 32, as the decode step does, so K/V rows
    come from device memory, not from a warm L2."""
    import torch
    import torch.nn.functional as F

    from llama2_tpu_torch.ops.cuda.attention import (
        flash_decode_attention_stacked,
        flash_decode_attention_stacked_plain,
    )
    from llama2_tpu_torch.ops.cuda.prefill_attention import (
        flash_prefill_attention,
        flash_prefill_attention_plain,
    )

    dn = dtype_name(dtype)
    esize = torch.tensor([], dtype=dtype).element_size()
    L, B, (H, KVH, hs) = 32, 1, LAYOUTS["7B"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    kc = torch.randn((L, B, KVH, S, hs), generator=gen, device="cuda").to(dtype)
    vc = torch.randn((L, B, KVH, S, hs), generator=gen, device="cuda").to(dtype)
    rows = []

    def row(name, src, replaces, n_launch, err, ms, plain_ms, lib_ms, nbytes, flops, shape="",
            t_ops=None):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dn] * 1e3 if t_ops is None else t_ops
        r = {
            "name": f"{name}[{dn}{shape}]", "route": "cuda", "source": src,
            "replaces": replaces, "launches": n_launch, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        }
        rows.append(r)
        return r

    # K1: the main path's prefill segment, [BOS] + prompt at pos 0
    T, pos0 = PROMPT_TOKENS + 1, 0
    q = torch.randn((L, B, T, H, hs), generator=gen, device="cuda").to(dtype)
    want = flash_prefill_attention_plain(q[0], kc[0], vc[0], pos0)
    err = compare(flash_prefill_attention(q[0], kc[0], vc[0], pos0), want, dtype)
    n = pos0 + T
    ms, qk = time_ms(
        lambda i: flash_prefill_attention(q[i % L], kc[i % L], vc[i % L], pos0), 64, cycles_per_ms
    )
    plain_ms, qp = time_ms(
        lambda i: flash_prefill_attention_plain(q[i % L], kc[i % L], vc[i % L], pos0), 16, cycles_per_ms
    )
    lib_ms, ql = time_ms(
        lambda i: F.scaled_dot_product_attention(
            q[i % L].transpose(1, 2), kc[i % L][:, :, :n], vc[i % L][:, :, :n], is_causal=True
        ), 64, cycles_per_ms,
    )
    vis = B * H * sum(pos0 + t + 1 for t in range(T))  # (query, key) pairs seen
    flops = 4 * hs * vis
    # fp32: float32-accurate on the tensor cores (three TF32 passes), the
    # float32 SIMT bound beside it
    simt = flops / PEAK_FLOPS["f32"] * 1e3
    r = row("flash_prefill_attention", "llama2_tpu_torch/csrc/prefill_attention.cu",
            "llama2_tpu/ops/pallas/prefill_attention.py:157", launches["K1"], err,
            ms, plain_ms, lib_ms,
            esize * (2 * B * T * H * hs + 2 * B * KVH * n * hs), flops,
            t_ops=accurate_ops_ms(flops, "tf32") if dtype == torch.float32 else None)
    say("time", kernel=r["name"], T=T, pos0=pos0, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{lib_ms:.4f}", bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"],
        **({"bound_ms_f32_simt": f"{max(simt, r['bound_ms']):.4f}"} if dtype == torch.float32 else {}),
        queued_kernel_plain_library=f"{qk},{qp},{ql}")
    del q

    # K2: one decode step at the main path's position, and at full context
    q = torch.randn((B, 1, H, hs), generator=gen, device="cuda").to(dtype)
    k_new = torch.randn((B, KVH, 1, hs), generator=gen, device="cuda").to(dtype)
    v_new = torch.randn((B, KVH, 1, hs), generator=gen, device="cuda").to(dtype)
    for p in (256, S - 1):
        pos = torch.tensor([p] * B, dtype=torch.int32, device="cuda")
        got = flash_decode_attention_stacked(q, kc, vc, k_new, v_new, 0, pos)
        want = flash_decode_attention_stacked_plain(q, kc.clone(), vc.clone(), k_new, v_new, 0, pos)
        err = compare(got, want, dtype)
        ms, qk = time_ms(
            lambda i: flash_decode_attention_stacked(q, kc, vc, k_new, v_new, i % L, pos), 256,
            cycles_per_ms,
        )
        plain_ms, qp = time_ms(
            lambda i: flash_decode_attention_stacked_plain(q, kc, vc, k_new, v_new, i % L, pos), 32,
            cycles_per_ms,
        )
        lib_ms, ql = time_ms(
            lambda i: F.scaled_dot_product_attention(
                q.transpose(1, 2), kc[i % L][:, :, : p + 1], vc[i % L][:, :, : p + 1]
            ), 256, cycles_per_ms,
        )
        nbytes = esize * (2 * B * H * hs + 2 * B * KVH * (p + 1) * hs + 2 * B * KVH * hs)
        # the main path's position, and full context as a second shape
        r = row("flash_decode_attention_stacked", "llama2_tpu_torch/csrc/decode_attention.cu",
                "llama2_tpu/ops/pallas/attention.py:338", launches["K2"], err,
                ms, plain_ms, lib_ms, nbytes, 4 * hs * B * H * (p + 1), "" if p == 256 else f",pos={p}")
        say("time", kernel=r["name"], pos=p, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{lib_ms:.4f}", bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"],
            max_abs_err=f"{err:.3e}", queued_kernel_plain_library=f"{qk},{qp},{ql}")
    del kc, vc
    torch.cuda.empty_cache()
    return rows


def q8_bounds_ms(M: int, K: int, N: int, mode: str, nbytes: int) -> tuple:
    """A dequant-matmul's least ms by bytes and by operations (fast: one bf16
    pass; accurate: three, ``accurate_ops_ms``), and accurate mode's old
    float32 SIMT bound by operations (None in fast mode)."""
    flops = 2 * M * K * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if mode == "fast":
        return t_bytes, flops / PEAK_FLOPS["bf16"] * 1e3, None
    return t_bytes, accurate_ops_ms(flops, "bf16"), flops / PEAK_FLOPS["f32"] * 1e3


MLP_LINES = {"K12": ("layer_tail_qkv_stacked", 792), "K11": ("attn_mlp_block_stacked", 463),
             "K10": ("mlp_block_stacked", 850)}


def mlp_timing(params, mats: dict, M: int, tags, cycles_per_ms: float, gen) -> dict:
    """The FFN megakernels ``tags`` (K12 with its qkv phase, K11, K10) at M
    rows of bf16 activations on the 32-layer 7B stack ``params`` (call i on
    layer i % 32, so weights come from device memory), against their plain
    versions at ``mlp_tolerance``. Beside each: its bound (each weight byte,
    scale and activation once over the memory rate, or 2 * M operations a
    weight over the bf16 peak), the composed route it replaces (the
    dequant-matmul launches and the plain rmsnorm, swiglu and add between
    them, as the ``w13`` layout runs them) and the sum of ``torch.matmul``
    on the weights dequantized ahead (``mats``: 4 layers each of wo, w13, w2
    and wqkv) at M rows. No one PyTorch call computes a megakernel, so
    ``library_ms`` is null. Each line says which form the calls took (where
    the wrapper counts forms). Returns the kernel line's rows by tag, without
    ``launches``."""
    import torch

    from llama2_tpu_torch.ops import ref
    from llama2_tpu_torch.ops.cuda import mlp_block as mb
    from llama2_tpu_torch.ops.cuda.quant_matmul import quant_matmul_stacked

    L, dtype, dn, esize, eps = 32, torch.bfloat16, "bf16", 2, 1e-5
    D, HD = Q8_SHAPES["w1"]
    Dq = Q8_SHAPES["wqkv"][1]
    wo, w1, w3, w2, w13, wqkv = (params[k] for k in ("wo", "w1", "w3", "w2", "w13", "wqkv"))
    rms_ffn, rms_att = params["rms_ffn"], params["rms_att"]
    x = torch.randn((M, D), generator=gen, device="cuda").to(dtype)
    att = torch.randn((M, D), generator=gen, device="cuda").to(dtype)
    xs = {"wo": att, "w13": x, "w2": torch.randn((M, HD), generator=gen, device="cuda").to(dtype),
          "wqkv": x}
    matmul_ms = {k: time_ms(lambda i, k=k: torch.matmul(xs[k], mats[k][i % 4]), 128, cycles_per_ms)[0]
                 for k in mats}

    def composed(i, with_wo, with_qkv):
        """The route of the w13 layout, as models/llama.py runs it."""
        l, nxt = i % L, min(i % L + 1, L - 1)
        r = quant_matmul_stacked(att, wo, l, residual=x) if with_wo else x
        h13 = quant_matmul_stacked(ref.rmsnorm(r, rms_ffn[l], eps), w13, l)
        out = r + quant_matmul_stacked(ref.swiglu(h13[..., :HD], h13[..., HD:]), w2, l)
        if with_qkv:
            return out, quant_matmul_stacked(out, wqkv, nxt, rms_w=rms_att[nxt], eps=eps)
        return out

    weights = D * D + 3 * D * HD + D * Dq  # int8 bytes of K12; K11 and K10 read fewer
    cases = {
        "K12": (weights, esize * M * (5 * D + Dq), ("wo", "w13", "w2", "wqkv"),
                lambda i: mb.layer_tail_qkv_stacked(att, x, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, i % L, eps),
                lambda i: mb.layer_tail_qkv_plain(att, x, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, i % L, eps),
                lambda i: composed(i, True, True)),
        "K11": (weights - D * Dq, esize * M * 4 * D, ("wo", "w13", "w2"),
                lambda i: mb.attn_mlp_block_stacked(att, x, wo, rms_ffn[i % L], w1, w3, w2, i % L, eps),
                lambda i: mb.attn_mlp_block_plain(att, x, wo, rms_ffn[i % L], w1, w3, w2, i % L, eps),
                lambda i: composed(i, True, False)),
        "K10": (3 * D * HD, esize * M * 3 * D, ("w13", "w2"),
                lambda i: mb.mlp_block_stacked(x, rms_ffn[i % L], w1, w3, w2, i % L, eps),
                lambda i: mb.mlp_block_plain(x, rms_ffn[i % L], w1, w3, w2, i % L, eps),
                lambda i: composed(i, False, False)),
    }
    rows = {}
    for tag in tags:
        wbytes, abytes, used, kern, plain, comp = cases[tag]
        kname, line = MLP_LINES[tag]
        wrapper = getattr(mb, kname)
        forms = {f: getattr(wrapper, f"launches_{f}", None) for f in ("mma", "fma")}
        got, want = kern(3), plain(3)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = max(compare(g_, w_, dtype, mlp_tolerance(dtype, w_)) for g_, w_ in zip(got, want))
        form = ",".join(f for f, n in forms.items() if n is not None and getattr(wrapper, f"launches_{f}") > n)
        ms, qk = time_ms(kern, 128, cycles_per_ms)
        plain_ms, qp = time_ms(plain, 8, cycles_per_ms, n_warm=1)
        # many small ops a call: few enough calls that the launch queue holds them all
        comp_ms, qc = time_ms(comp, 32, cycles_per_ms, slack=3.0)
        nbytes = wbytes + 4 * wbytes // GROUP + abytes  # one f32 scale per 64 values
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * M * wbytes / PEAK_FLOPS["bf16"] * 1e3
        bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        name = f"{kname}[{dn},M={M}]"
        say("time", kernel=name, tag=tag, M=M, form=form or "not_counted", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", composed_route_ms=f"{comp_ms:.4f}",
            library_ms="none_(no_single_call)",
            matmul_on_dequantized_sum_ms=f"{sum(matmul_ms[m] for m in used):.4f}",
            bound_ms=f"{bound:.4f}", bound_by=by, share_of_bound=f"{bound / ms:.3f}",
            MB=f"{nbytes / 1e6:.1f}", GB_per_s=f"{nbytes / ms / 1e6:.0f}", max_abs_err=f"{err:.3e}",
            queued_kernel_plain_composed=f"{qk},{qp},{qc}")
        rows[tag] = {
            "name": name, "route": "cuda", "source": "llama2_tpu_torch/csrc/mlp_block.cu",
            "replaces": f"llama2_tpu/ops/pallas/mlp_block.py:{line}", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None,
        }
    return rows


def phase_timing_q8(launches: dict, cycles_per_ms: float) -> list[dict]:
    """K5/K6 at the 7B shapes, M = 1 (a decode step) and M = 201 (the
    prefill chunk), fast mode on bf16 activations and accurate mode on fp32;
    K10-K12 at M = 1 and K12, K11 at the served tick's M = 8 on bf16
    activations (``mlp_timing``), K13 at 8 rows (``k13_batch_timing``); and K4
    at pos 256 and 4095. Call i reads layer i % 32 of a 32-layer stack, as
    the decode step does, so weights come from device memory.

    Bound: each weight byte, scale and activation once (K*N + 4*(K/G)*N +
    activations) over the memory rate, or 2*M*K*N operations over the bf16
    peak, three times over in accurate mode (``accurate_ops_ms``; the float32
    SIMT bound is printed beside it). The library yardstick is ``torch.matmul`` on
    the weight dequantized ahead of time, in the activation dtype: it reads
    2x (bf16) or 4x (fp32) the kernel's weight bytes and does no dequantizing.
    No one PyTorch call computes an FFN megakernel, so its ``library_ms`` is
    null; its line gives the composed route it replaces (the dequant-matmul
    launches and the plain rmsnorm, swiglu and add between them, as the
    ``w13`` layout runs them) and the sum of the matmul yardsticks instead.
    ``launches``: the Q8 routes' counts, by the names ``main`` gives them
    (the M = 201 rows: the accurate route's prefill-chunk tile launches; the
    8-row rows: the served runs', "served").
    """
    import torch
    import torch.nn.functional as F

    from llama2_tpu_torch.io.convert import random_q8_params
    from llama2_tpu_torch.ops import ref
    from llama2_tpu_torch.ops.cuda import mlp_block as mb
    from llama2_tpu_torch.ops.cuda.attention import (
        flash_decode_attention_fused,
        flash_decode_attention_fused_plain,
    )
    from llama2_tpu_torch.ops.cuda.quant_matmul import (
        quant_matmul,
        quant_matmul_plain,
        quant_matmul_stacked,
        quant_matmul_stacked_plain,
    )
    from llama2_tpu_torch.quant.q8 import dequantize

    L = 32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    params = all_layouts(random_q8_params(config_7b(L), SEED + 5, "cuda", torch.bfloat16, group_size=GROUP))
    rows = []
    src = "llama2_tpu_torch/csrc/quant_matmul.cu"
    for mode, dtype in (("fast", torch.bfloat16), ("accurate", torch.float32)):
        dn = dtype_name(dtype)
        esize = torch.tensor([], dtype=dtype).element_size()
        for name, (K, N) in Q8_SHAPES.items():
            w = params[name]
            stacked = w.q.ndim == 3
            # the yardstick's weights: 4 layers dequantized ahead (more than L2 holds)
            wd = dequantize(w[:4], dtype) if stacked else dequantize(w, dtype)[None]
            for M in (1, PROMPT_TOKENS + 1):
                x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
                if stacked:
                    def kern(i): return quant_matmul_stacked(x, w, i % L, mode=mode)
                    def plain(i): return quant_matmul_stacked_plain(x, w, i % L, mode=mode)
                else:
                    def kern(i): return quant_matmul(x, w, mode=mode)
                    def plain(i): return quant_matmul_plain(x, w, mode=mode)
                def lib(i): return torch.matmul(x, wd[i % wd.shape[0]])
                err = compare(kern(0), plain(0), dtype, q8_tolerance(dtype, mode, False))
                ms, qk = time_ms(kern, 128 if M == 1 else 16, cycles_per_ms)
                plain_ms, qp = time_ms(plain, 8, cycles_per_ms, n_warm=1)
                lib_ms, ql = time_ms(lib, 128 if M == 1 else 16, cycles_per_ms)
                nbytes = K * N + 4 * (K // GROUP) * N + esize * (M * K + M * N)
                t_bytes, t_ops, simt = q8_bounds_ms(M, K, N, mode, nbytes)
                bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
                kname = "quant_matmul_stacked" if stacked else "quant_matmul"
                say("time", kernel=f"{kname}[{dn},{mode}]", weight=name, M=M, K=K, N=N,
                    ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                    library_ms_matmul_on_dequantized=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}",
                    bound_by=by, **({"bound_ms_f32_simt": f"{max(t_bytes, simt):.4f}"} if simt else {}),
                    GB_per_s=f"{nbytes / ms / 1e6:.0f}",
                    TFLOP_per_s=f"{2 * M * K * N / ms / 1e9:.2f}", max_abs_err=f"{err:.3e}",
                    queued_kernel_plain_library=f"{qk},{qp},{ql}")
                # the kernel line's rows: the main path's decode rows, and the
                # accurate route's prefill chunk (K6 on the accurate M > 8 tile)
                if name in (("wqkv", "wcls") if M == 1 else ("w13",) if mode == "accurate" else ()):
                    key = ("K6" if stacked else "K5") + ("-tile-acc" if M > 8 else "")
                    rows.append({
                        "name": f"{kname}[{dn},{mode},{name},M={M}]", "route": "cuda", "source": src,
                        "replaces": "llama2_tpu/ops/pallas/quant_matmul.py:"
                        + ("340" if stacked else "476"),
                        "launches": launches[mode][key],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by, "library_ms": lib_ms,
                    })
            del wd

    # K10-K12: one decode row of bf16 activations; K12 and K11 at the served
    # tick's 8 rows (the tensor-core form)
    mats = {k: dequantize(params[k][:4], torch.bfloat16) for k in ("wo", "w13", "w2", "wqkv")}
    for M, tags in ((1, ("K12", "K11", "K10")), (8, ("K12", "K11"))):
        for tag, r in mlp_timing(params, mats, M, tags, cycles_per_ms, gen).items():
            n_launch = (launches["fast"][tag] if tag != "K10" else launches["ffn-only"]["K10"]) if M == 1 \
                else launches["served"][tag]
            rows.append({**r, "launches": n_launch})
    del mats
    rows.append({**k13_batch_timing(params, cycles_per_ms), "launches": launches["served"]["K13"]})
    kv_launches = {"K7": launches["int8kv"]["spec"]["K7"], "K8": launches["int8kv-accurate"]["K8"],
                   "K9": launches["int8kv-two-launch"]["K9"], "K13": launches["int8kv"]["K13"]}
    rows += phase_timing_q8kv(params, kv_launches, cycles_per_ms)
    del params
    torch.cuda.empty_cache()

    # K4 on the fast path's bf16 cache
    dtype, dn, esize = torch.bfloat16, "bf16", 2
    B, (H, KVH, hs) = 1, LAYOUTS["7B"]
    kc = torch.randn((L, B, KVH, S, hs), generator=gen, device="cuda").to(dtype)
    vc = torch.randn((L, B, KVH, S, hs), generator=gen, device="cuda").to(dtype)
    qkv = torch.randn((B, H + 2 * KVH, hs), generator=gen, device="cuda").to(dtype)
    q = qkv[:, None, :H].transpose(1, 2).contiguous()  # the yardstick's (B, H, 1, hs)
    for p in (256, S - 1):
        pos = torch.tensor([p] * B, dtype=torch.int32, device="cuda")
        cos_il, sin_il = rope_tables(pos, hs)
        got = flash_decode_attention_fused(qkv, kc, vc, cos_il, sin_il, 0, pos, n_heads=H)
        want = flash_decode_attention_fused_plain(
            qkv, kc.clone(), vc.clone(), cos_il, sin_il, 0, pos, H
        )
        err = compare(got, want, dtype)
        ms, qk = time_ms(
            lambda i: flash_decode_attention_fused(qkv, kc, vc, cos_il, sin_il, i % L, pos, n_heads=H),
            256, cycles_per_ms,
        )
        plain_ms, qp = time_ms(
            lambda i: flash_decode_attention_fused_plain(qkv, kc, vc, cos_il, sin_il, i % L, pos, H),
            32, cycles_per_ms,
        )
        lib_ms, ql = time_ms(
            lambda i: F.scaled_dot_product_attention(
                q, kc[i % L][:, :, : p + 1], vc[i % L][:, :, : p + 1]
            ), 256, cycles_per_ms,
        )
        # qkv rows and the tables in, the output and the two new rows out,
        # and keys 0..p of K and V
        nbytes = (esize * (B * (H + 2 * KVH) * hs + B * H * hs + 2 * B * KVH * hs
                           + 2 * B * KVH * (p + 1) * hs) + 8 * B * hs)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 4 * hs * B * H * (p + 1) / PEAK_FLOPS[dn] * 1e3
        bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        name = f"flash_decode_attention_fused[{dn}{'' if p == 256 else f',pos={p}'}]"
        # the main path's position, and full context as a second shape
        rows.append({
            "name": name, "route": "cuda",
            "source": "llama2_tpu_torch/csrc/decode_attention.cu",
            "replaces": "llama2_tpu/ops/pallas/attention.py:515",
            "launches": launches["fast"]["K4"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
        })
        say("time", kernel=name, pos=p, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=by,
            max_abs_err=f"{err:.3e}", queued_kernel_plain_library=f"{qk},{qp},{ql}")
    del kc, vc
    torch.cuda.empty_cache()
    return rows


def k13_batch_timing(params, cycles_per_ms: float) -> dict:
    """K13 at the dense engine's 8 rows over a 32-layer int8 cache at the 7B
    widths, every row at pos 256 and at 4095 (call i on layer i % 32),
    against its plain version (K13_PLAIN_TOL), beside its bound (K12's
    weights, scales and activations and the K/V rows of keys 0..pos of the
    8 rows once, or two operations a weight a row and 4 * hs a (query head,
    key) pair, over the bf16 peak) and the K9 + K12 pair it replaces, queued
    back to back. Returns the kernel line's row at pos 256, without
    ``launches``."""
    import torch

    from llama2_tpu_torch.ops.cuda import attention_q8 as aq
    from llama2_tpu_torch.ops.cuda import layer_block as lb
    from llama2_tpu_torch.ops.cuda import mlp_block as mb

    dtype, dn, esize = torch.bfloat16, "bf16", 2
    L, B, (H, KVH, hs) = 32, SERVE_SLOTS, LAYOUTS["7B"]
    D = H * hs
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    shape = (L, B, KVH, S, hs)
    k8 = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    v8 = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    ks = 0.02 + 0.01 * torch.rand(shape[:-1], generator=gen, device="cuda")
    vs = 0.02 + 0.01 * torch.rand(shape[:-1], generator=gen, device="cuda")
    qkv = randn(B, H + 2 * KVH, hs).to(dtype)
    x = randn(B, D).to(dtype)
    weights = [params[k] for k in ("wo", "rms_ffn", "w1", "w3", "w2", "rms_att", "wqkv")]
    wbytes = sum(params[k].q[0].numel() for k in ("wo", "w1", "w3", "w2", "wqkv"))
    row = None
    for p in (256, S - 1):
        pos = torch.full((B,), p, dtype=torch.int32, device="cuda")
        cos_il, sin_il = rope_tables(pos, hs)

        def kern(i):
            return lb.layer_block_stacked(qkv, x, k8, ks, v8, vs, cos_il, sin_il, *weights, i % L, pos,
                                          n_heads=H)

        def plain(i):
            return lb.layer_block_stacked_plain(qkv, x, k8, ks, v8, vs, cos_il, sin_il, *weights, i % L, pos,
                                                n_heads=H)

        def pair(i):
            att = aq.flash_decode_attention_q8_fused(qkv, k8, ks, v8, vs, cos_il, sin_il, i % L, pos, n_heads=H)
            return mb.layer_tail_qkv_stacked(att.reshape(B, D), x, *weights[:6], weights[6], i % L)

        n0 = getattr(lb.layer_block_stacked, "launches_mma", None)
        got, want = kern(0), plain(0)
        torch.cuda.synchronize()
        form = "not_counted" if n0 is None else "mma" if lb.layer_block_stacked.launches_mma > n0 else "fma"
        err = max(compare(g_, w_, dtype, (2**-7, K13_PLAIN_TOL * float(w_.float().abs().max())))
                  for g_, w_ in zip(got, want))
        ms, qk = time_ms(kern, 64, cycles_per_ms)
        plain_ms, qp = time_ms(plain, 4, cycles_per_ms, n_warm=1)
        pair_ms, qy = time_ms(pair, 64, cycles_per_ms)
        nbytes = (wbytes + 4 * wbytes // GROUP + esize * B * (4 * D + 2 * (H + 2 * KVH) * hs)
                  + B * KVH * (p + 1) * (2 * hs + 8) + 8 * B * hs)
        flops = 2 * B * wbytes + 4 * hs * B * H * (p + 1)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bf16"] * 1e3
        bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        name = f"layer_block_stacked[{dn},M={B}]"
        say("time", kernel=name, pos=p, form=form, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            yardstick_K9_K12_pair_ms=f"{pair_ms:.4f}", library_ms="none_(no_single_call)",
            bound_ms=f"{bound:.4f}", bound_by=by, share_of_bound=f"{bound / ms:.3f}",
            MB=f"{nbytes / 1e6:.1f}", GB_per_s=f"{nbytes / ms / 1e6:.0f}", max_abs_err=f"{err:.3e}",
            queued_kernel_plain_yardstick=f"{qk},{qp},{qy}")
        if p == 256:
            row = {"name": name, "route": "cuda", "source": "llama2_tpu_torch/csrc/mlp_block.cu",
                   "replaces": "llama2_tpu/ops/pallas/layer_block.py:749", "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None}
    del k8, v8, ks, vs
    torch.cuda.empty_cache()
    return row


def phase_tick_timing(cycles_per_ms: float) -> None:
    """The served decode tick's kernels alone, for comparing two trees in one
    call: ``python3 chip_smoke.py --tick-timing`` runs it and nothing else.
    At the 7B widths, bf16 activations: K12 (with its qkv phase), K11 and K10
    at M = 1, 2, 4 and 8 (``mlp_timing``: beside the composed route and the
    summed bf16 matmuls on the dequantized weights at the same M); K13 at 8
    rows at pos 256 and 4095 (``k13_batch_timing``: beside the K9 + K12 pair);
    K15-K18 at 8 slots on 256-row pages at pos 256 and 4095, bf16
    (``phase_timing_paged``: beside the dense twins K2 / K8 / K4 / K9 and
    SDPA on the gathered rows), K15 again over an fp32 pool (the served
    ``cuda-accurate`` path's), and at pos 4095 K18 and K17 at other split
    counts where the tree has their plans (``q8_plan``, ``fp_plan``). Each
    with its bound and its plain version. It calls the wrappers by their
    public signatures only, so this script also times an older checkout:
    copy it into one and run it from that checkout's root."""
    import torch

    from llama2_tpu_torch.io.convert import random_q8_params
    from llama2_tpu_torch.quant.q8 import dequantize

    params = all_layouts(random_q8_params(config_7b(32), SEED + 5, "cuda", torch.bfloat16, group_size=GROUP))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    mats = {k: dequantize(params[k][:4], torch.bfloat16) for k in ("wo", "w13", "w2", "wqkv")}
    for M in (1, 2, 4, 8):
        mlp_timing(params, mats, M, ("K12", "K11", "K10"), cycles_per_ms, gen)
    del mats
    k13_batch_timing(params, cycles_per_ms)
    del params
    torch.cuda.empty_cache()
    phase_timing_paged(dict.fromkeys(("K15", "K16", "K17", "K18"), 0), cycles_per_ms, sweep=True)
    phase_timing_paged({"K15": 0}, cycles_per_ms, tags=("K15",), dtype=torch.float32)


def q8kv_batch_timing(cycles_per_ms: float) -> None:
    """K8 and K9 at the dense engine's 8 rows over an 8-layer int8 cache at
    the 7B head layout, bf16 activations, every row at pos 256 and at 4095
    (call i on layer i % 8: 2.2 GB of rows a round, past the L2), against
    their plain versions (``q8kv_tolerance``), beside their bound (the K/V
    rows of keys 0..pos of the 8 rows and the activations once, over the
    memory rate) and SDPA on a bf16 cache of the same rows."""
    import torch
    import torch.nn.functional as F

    from llama2_tpu_torch.ops.cuda import attention_q8 as aq

    dtype, dn, esize = torch.bfloat16, "bf16", 2
    L, B, (H, KVH, hs) = 8, SERVE_SLOTS, LAYOUTS["7B"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    k8, ks = aq.quantize_kv_rows(randn(L, B, KVH, S, hs))
    v8, vs = aq.quantize_kv_rows(randn(L, B, KVH, S, hs))
    kb, vb = aq.dequantize_kv(k8, ks).to(dtype), aq.dequantize_kv(v8, vs).to(dtype)
    q1, qkv = randn(B, H, hs).to(dtype), randn(B, H + 2 * KVH, hs).to(dtype)
    kn, ksn = aq.quantize_kv_rows(randn(B, KVH, 1, hs))
    vn, vsn = aq.quantize_kv_rows(randn(B, KVH, 1, hs))
    for p in (256, S - 1):
        pos = torch.full((B,), p, dtype=torch.int32, device="cuda")
        cos_il, sin_il = rope_tables(pos, hs)
        q_rot = aq.rope_quantize_plain(qkv, cos_il, sin_il, H)[0]
        qt = q1[:, :, None]
        cases = (
            ("K8", f"flash_decode_attention_q8_stacked[{dn},M={B}]", q1,
             lambda i: aq.flash_decode_attention_q8_stacked(q1, k8, ks, v8, vs, kn, ksn, vn, vsn, i % L, pos),
             lambda i: aq.flash_decode_attention_q8_stacked_plain(q1, k8, ks, v8, vs, kn, ksn, vn, vsn, i % L, pos),
             2 * esize * B * H * hs + B * KVH * (2 * hs + 8)),
            ("K9", f"flash_decode_attention_q8_fused[{dn},M={B}]", q_rot,
             lambda i: aq.flash_decode_attention_q8_fused(qkv, k8, ks, v8, vs, cos_il, sin_il, i % L, pos, n_heads=H),
             lambda i: aq.flash_decode_attention_q8_fused_plain(qkv, k8, ks, v8, vs, cos_il, sin_il, i % L, pos, H),
             esize * B * (2 * H + 2 * KVH) * hs + 8 * B * hs),
        )
        for tag, name, qq, kern, plain, extra in cases:
            got, want = kern(0), plain(0)
            torch.cuda.synchronize()
            _, A, R = q8kv_terms(qq[:, None], k8[0], ks[0], v8[0], vs[0], pos.long()[:, None])
            err = compare(got, want, dtype, q8kv_tolerance(dtype, A[:, 0], R[:, 0]))
            ms, qk = time_ms(kern, 128, cycles_per_ms)
            plain_ms, qp = time_ms(plain, 4, cycles_per_ms, n_warm=1)
            sdpa_ms, qs = time_ms(lambda i: F.scaled_dot_product_attention(
                qt, kb[i % L][:, :, : p + 1], vb[i % L][:, :, : p + 1]), 128, cycles_per_ms)
            nbytes = B * KVH * (p + 1) * (2 * hs + 8) + extra
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 4 * hs * B * H * (p + 1) / PEAK_FLOPS["bf16"] * 1e3
            bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
            say("time", kernel=name, pos=p, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                yardstick_SDPA_bf16_cache_ms=f"{sdpa_ms:.4f}", library_ms="none_(no_single_call)",
                bound_ms=f"{bound:.4f}", bound_by=by, share_of_bound=f"{bound / ms:.3f}",
                MB=f"{nbytes / 1e6:.1f}", GB_per_s=f"{nbytes / ms / 1e6:.0f}", max_abs_err=f"{err:.3e}",
                queued_kernel_plain_yardstick=f"{qk},{qp},{qs}")
    del k8, v8, kb, vb
    torch.cuda.empty_cache()


def q8kv_split_sweep(cycles_per_ms: float) -> None:
    """K9 and K7 (T = 4) at batch 1 and pos 4095 over a 32-layer int8 cache
    at the 7B head layout at split counts other than their plan's, where the
    tree launches them from ``attention_q8.q8_plan`` (its ``_launch`` takes
    ``splits``)."""
    import inspect

    import torch

    from llama2_tpu_torch.ops.cuda import attention_q8 as aq

    if "splits" not in inspect.signature(aq._launch).parameters:
        say("time", split_sweep="not_in_this_tree")
        return
    dtype, L, B, (H, KVH, hs), p = torch.bfloat16, 32, 1, LAYOUTS["7B"], S - 1
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    k8, ks = aq.quantize_kv_rows(torch.randn((L, B, KVH, S, hs), generator=gen, device="cuda"))
    v8, vs = aq.quantize_kv_rows(torch.randn((L, B, KVH, S, hs), generator=gen, device="cuda"))
    pos = torch.full((B,), p, dtype=torch.int32, device="cuda")
    cos_il, sin_il = rope_tables(pos, hs)
    qkv = torch.randn((B, H + 2 * KVH, hs), generator=gen, device="cuda").to(dtype)
    q4 = torch.randn((B, 4, H, hs), generator=gen, device="cuda").to(dtype)
    out1, out4 = torch.empty((B, H, hs), dtype=dtype, device="cuda"), torch.empty_like(q4)
    sms = aq._sms(torch.cuda.current_device())
    for tag, T in (("K9", 1), ("K7", 4)):
        own = aq.q8_plan(B, H, KVH, S, hs, sms, T=T)["splits"]
        times = {}
        for n in sorted({1, 2, 4, 8, 12, 16, 24, 32, own}):
            if tag == "K9":
                def call(i, n=n):
                    aq._launch(aq.flash_decode_attention_q8_fused, "fused", qkv=qkv, caches=(k8, ks, v8, vs),
                               pos=pos, out=out1, L=L, layer=i % L, T=1, H=H, rope=(cos_il, sin_il), splits=n)
            else:
                def call(i, n=n):
                    aq._launch(aq.flash_decode_attention_q8, "window", q=q4,
                               caches=(k8[i % L], ks[i % L], v8[i % L], vs[i % L]), pos=pos, out=out4, L=1,
                               layer=0, T=4, H=H, splits=n)
            times[n] = time_ms(call, 256, cycles_per_ms)[0]
        say("time", kernel=f"{tag}_split_sweep", pos=p, plan_splits=own,
            **{f"splits_{n}_ms": f"{t:.4f}" for n, t in times.items()})
    del k8, v8
    torch.cuda.empty_cache()


def phase_q8kv_timing(cycles_per_ms: float) -> None:
    """The int8-cache decode step's kernels alone, for comparing two trees in
    one call: ``python3 chip_smoke.py --q8kv-timing`` runs it and nothing
    else. At the 7B widths, bf16 activations: K7 (T = 1 and 4), K8, K9 and
    K13 at batch 1 (``phase_timing_q8kv``: K13 beside the K9 + K12 pair), K8
    and K9 at 8 rows (``q8kv_batch_timing``), K13 at 8 rows
    (``k13_batch_timing``), each at pos 256 and 4095 with its bound and its
    plain version; K12 (the same megakernel without the attention phase) at
    1 and 8 rows (``mlp_timing``); then the split-count sweep
    (``q8kv_split_sweep``). It
    calls the wrappers by their public signatures only (the sweep excepted,
    which a tree without it skips), so this script also times an older
    checkout: copy it into one and run it from that checkout's root."""
    import torch

    from llama2_tpu_torch.io.convert import random_q8_params
    from llama2_tpu_torch.quant.q8 import dequantize

    params = all_layouts(random_q8_params(config_7b(32), SEED + 5, "cuda", torch.bfloat16, group_size=GROUP))
    phase_timing_q8kv(params, {tag: 0 for tag in ("K7", "K8", "K9", "K13")}, cycles_per_ms)
    k13_batch_timing(params, cycles_per_ms)
    # K12, the megakernel without the attention phase, at K13's row counts
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    mats = {k: dequantize(params[k][:4], torch.bfloat16) for k in ("wo", "w13", "w2", "wqkv")}
    for M in (1, 8):
        mlp_timing(params, mats, M, ("K12",), cycles_per_ms, gen)
    del params, mats
    torch.cuda.empty_cache()
    q8kv_batch_timing(cycles_per_ms)
    q8kv_split_sweep(cycles_per_ms)


def phase_timing_q8kv(params, launches: dict, cycles_per_ms: float) -> list[dict]:
    """K7 (T = 1 and 4), K8, K9 and K13 at pos 256 and 4095 over a 32-layer
    int8 cache at the 7B head layout, bf16 activations (the main path's);
    call i reads layer i % 32. Bound: each byte once, the K/V rows of keys
    0..pos (int8, plus a float32 scale a row) and the activations, over the
    memory rate; or 4 * hs operations a (query row, visible key) pair over
    the bf16 peak (int8 -> bf16 is exact: the dots are bf16 dots); K13 adds
    K12's weights, scales and activations and two operations a weight. No
    PyTorch call computes an int8-cache attention, so ``library_ms`` is null;
    the printed yardstick is SDPA on a bf16 cache of the same length (K7-K9)
    and the K9 + K12 pair that K13 replaces, queued back to back."""
    import torch
    import torch.nn.functional as F

    from llama2_tpu_torch.ops.cuda import attention_q8 as aq
    from llama2_tpu_torch.ops.cuda import layer_block as lb
    from llama2_tpu_torch.ops.cuda import mlp_block as mb

    dtype, dn, esize = torch.bfloat16, "bf16", 2
    L, B, (H, KVH, hs) = 32, 1, LAYOUTS["7B"]
    D = H * hs
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    k8, ks = aq.quantize_kv_rows(randn(L, B, KVH, S, hs))
    v8, vs = aq.quantize_kv_rows(randn(L, B, KVH, S, hs))
    kb = aq.dequantize_kv(k8, ks).to(dtype)  # the yardstick's bf16 cache
    vb = aq.dequantize_kv(v8, vs).to(dtype)
    qkv = randn(B, H + 2 * KVH, hs).to(dtype)
    x = randn(B, D).to(dtype)
    kn, ksn = aq.quantize_kv_rows(randn(B, KVH, 1, hs))
    vn, vsn = aq.quantize_kv_rows(randn(B, KVH, 1, hs))
    weights = [params[k] for k in ("wo", "rms_ffn", "w1", "w3", "w2", "rms_att", "wqkv")]
    wo, _, w1, w3, w2, _, wqkv = weights
    wbytes = sum(w.q[0].numel() for w in (wo, w1, w3, w2, wqkv))
    rows, src = [], "llama2_tpu_torch/csrc/attention_q8.cu"

    def kv_bytes(p):
        return B * KVH * (p + 1) * (2 * hs + 8)

    for p in (256, S - 1):
        pos = torch.tensor([p] * B, dtype=torch.int32, device="cuda")
        cos_il, sin_il = rope_tables(pos, hs)
        cases = []
        for T in (1, 4):
            q = randn(B, T, H, hs).to(dtype)
            qt = q.transpose(1, 2)
            cases.append((
                f"flash_decode_attention_q8[{dn},T={T}]", "K7", 766,
                lambda i, q=q: aq.flash_decode_attention_q8(q, k8[i % L], ks[i % L], v8[i % L], vs[i % L], p),
                lambda i, q=q: aq.flash_decode_attention_q8_plain(q, k8[i % L], ks[i % L], v8[i % L], vs[i % L], p),
                lambda i, qt=qt: F.scaled_dot_product_attention(qt, kb[i % L][:, :, : p + 1], vb[i % L][:, :, : p + 1]),
                "SDPA_bf16_cache", kv_bytes(p) + 2 * esize * B * T * H * hs,
                4 * hs * B * H * sum(p - (T - 1) + t + 1 for t in range(T)),
                (q, p - (T - 1) + torch.arange(T, device="cuda")[None, :].expand(B, T)), lambda t: t))
        q1 = randn(B, H, hs).to(dtype)
        qt1 = q1[:, :, None]
        sdpa = lambda i: F.scaled_dot_product_attention(qt1, kb[i % L][:, :, : p + 1], vb[i % L][:, :, : p + 1])
        ops = 4 * hs * B * H * (p + 1)
        cases.append((
            f"flash_decode_attention_q8_stacked[{dn}]", "K8", 528,
            lambda i: aq.flash_decode_attention_q8_stacked(q1, k8, ks, v8, vs, kn, ksn, vn, vsn, i % L, pos),
            lambda i: aq.flash_decode_attention_q8_stacked_plain(q1, k8, ks, v8, vs, kn, ksn, vn, vsn, i % L, pos),
            sdpa, "SDPA_bf16_cache", kv_bytes(p) + 2 * esize * B * H * hs + B * KVH * (2 * hs + 8), ops,
            (q1[:, None], pos.long()[:, None]), lambda t: t[:, 0]))
        cases.append((
            f"flash_decode_attention_q8_fused[{dn}]", "K9", 716,
            lambda i: aq.flash_decode_attention_q8_fused(qkv, k8, ks, v8, vs, cos_il, sin_il, i % L, pos, n_heads=H),
            lambda i: aq.flash_decode_attention_q8_fused_plain(qkv, k8, ks, v8, vs, cos_il, sin_il, i % L, pos, H),
            sdpa, "SDPA_bf16_cache",
            kv_bytes(p) + esize * B * (H + 2 * KVH + H) * hs + 8 * B * hs, ops,
            (aq.rope_quantize_plain(qkv, cos_il, sin_il, H)[0][:, None], pos.long()[:, None]), lambda t: t[:, 0]))

        def pair(i):
            att = aq.flash_decode_attention_q8_fused(qkv, k8, ks, v8, vs, cos_il, sin_il, i % L, pos, n_heads=H)
            return mb.layer_tail_qkv_stacked(att.reshape(B, D), x, *weights[:6], wqkv, i % L)

        cases.append((
            f"layer_block_stacked[{dn},M=1]", "K13", 749,
            lambda i: lb.layer_block_stacked(qkv, x, k8, ks, v8, vs, cos_il, sin_il, *weights, i % L, pos,
                                             n_heads=H),
            lambda i: lb.layer_block_stacked_plain(qkv, x, k8, ks, v8, vs, cos_il, sin_il, *weights, i % L, pos,
                                                   n_heads=H),
            pair, "K9+K12_pair",
            wbytes + 4 * wbytes // GROUP + esize * B * (4 * D + 2 * (H + 2 * KVH) * hs)
            + kv_bytes(p) + 8 * B * hs,
            2 * wbytes + ops, None, None))
        for name, tag, line, kern, plain, yard, yname, nbytes, flops, terms, shape in cases:
            got, want = kern(0), plain(0)
            torch.cuda.synchronize()
            if tag == "K13":
                err = max(compare(g_, w_, dtype, (2**-7, K13_PLAIN_TOL * float(w_.float().abs().max())))
                          for g_, w_ in zip(got, want))
            else:
                # layer 0, the first call's: K8 and K9 appended this step's row there
                _, A, R = q8kv_terms(terms[0], k8[0], ks[0], v8[0], vs[0], terms[1])
                err = compare(got, want, dtype, q8kv_tolerance(dtype, shape(A), shape(R)))
            n_iter = 128 if tag == "K13" else 256
            ms, qk = time_ms(kern, n_iter, cycles_per_ms)
            plain_ms, qp = time_ms(plain, 8, cycles_per_ms, n_warm=1)
            yard_ms, qy = time_ms(yard, n_iter, cycles_per_ms)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS["bf16"] * 1e3
            bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
            say("time", kernel=name, pos=p, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                **{f"yardstick_{yname}_ms": f"{yard_ms:.4f}"}, library_ms="none_(no_single_call)",
                bound_ms=f"{bound:.4f}", bound_by=by, MB=f"{nbytes / 1e6:.2f}",
                GB_per_s=f"{nbytes / ms / 1e6:.0f}", max_abs_err=f"{err:.3e}",
                queued_kernel_plain_yardstick=f"{qk},{qp},{qy}")
            if p == 256:  # the kernel line's rows; full context is printed and kept in PERF.md
                rows.append({
                    "name": name, "route": "cuda",
                    "source": "llama2_tpu_torch/csrc/mlp_block.cu" if tag == "K13" else src,
                    "replaces": f"llama2_tpu/ops/pallas/{'layer_block' if tag == 'K13' else 'attention_q8'}.py:{line}",
                    "launches": launches[tag], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": by, "library_ms": None,
                })
    del k8, v8, kb, vb
    torch.cuda.empty_cache()
    return rows


PAGED_LINES = {"K15": 364, "K16": 629, "K17": 824, "K18": 1015}


def phase_timing_paged(launches: dict, cycles_per_ms: float, tags=("K15", "K16", "K17", "K18"),
                       sweep: bool = False, dtype=None) -> list[dict]:
    """K15-K18 at the served path's shapes: 8 slots at the 7B head layout,
    256-row pages handed out shuffled, every slot at pos 256 and at 4095,
    bf16 activations (or ``dtype``) over a pool of that dtype (K15, K17) and
    an int8 pool (K16, K18). Four layers of pool; call i uses layer i % 4,
    and a layer's K/V (34-537 MB in bf16) passes the 50 MB L2. Bound: each
    byte once, the K/V rows of keys 0..pos of every slot (int8 plus two
    float32 scales a row) and the activations, over the memory rate; or
    4 * hs operations a (query head, key) pair over the dtype's peak. No
    PyTorch call computes paged attention, so ``library_ms`` is null;
    printed beside it are SDPA on a dense cache of the same lengths and
    dtype and the dense twin kernel (K2, K8, K4, K9) on the same rows
    gathered into a dense cache. ``tags``: the kernels timed; ``sweep``: at
    pos 4095 also K18 at other split counts (``q8_plan``'s ``splits``) and
    K17 at 1, 2 and 4 splits (``_fp_launch``'s ``splits``), where the tree
    has those plans."""
    import inspect

    import torch
    import torch.nn.functional as F

    from llama2_tpu_torch.ops.cuda import attention as fa
    from llama2_tpu_torch.ops.cuda import attention_q8 as aq
    from llama2_tpu_torch.ops.cuda import paged_attention as tpa

    dtype = dtype or torch.bfloat16
    dn, esize = dtype_name(dtype), dtype.itemsize
    q8_tags = {"K16", "K18"} & set(tags)
    L, B, page, (H, KVH, hs) = 4, SERVE_SLOTS, SERVE_PAGE, LAYOUTS["7B"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    cpu_gen = torch.Generator().manual_seed(SEED + 13)
    rows, src = [], "llama2_tpu_torch/csrc/paged_attention.cu"
    fp_sweep = sweep and "splits" in inspect.signature(tpa._fp_launch).parameters

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, qkv = randn(B, H, hs), randn(B, H + 2 * KVH, hs)
    kn, vn = randn(B, KVH, 1, hs), randn(B, KVH, 1, hs)
    k8n, ksn = aq.quantize_kv_rows(kn.float())
    v8n, vsn = aq.quantize_kv_rows(vn.float())
    for p in (256, S - 1):
        n = p // page + 1
        n_pages = B * n + 1
        perm = (torch.randperm(n_pages - 1, generator=cpu_gen) + 1).reshape(B, n)
        table = torch.zeros((B, S // page), dtype=torch.int32)
        table[:, :n] = perm
        table = table.cuda()
        pos = torch.full((B,), p, dtype=torch.int32, device="cuda")
        wpage = table[:, p // page].contiguous()
        wrow = (pos % page).contiguous()
        cos_il, sin_il = rope_tables(pos, hs)
        shape = (L, n_pages, KVH, page, hs)
        kp = torch.empty(shape, dtype=dtype, device="cuda").normal_(generator=gen)
        vp = torch.empty(shape, dtype=dtype, device="cuda").normal_(generator=gen)
        # the dense twins' caches: the same rows, gathered (L, B, KVH, n * page, hs)
        kd, vd = (torch.stack([tpa.gather_pages(t[l], table, n) for l in range(L)]) for t in (kp, vp))
        q8 = q8d = None
        if q8_tags:
            k8 = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
            v8 = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
            ks = 0.02 + 0.01 * torch.rand(shape[:-1], generator=gen, device="cuda")
            vs = 0.02 + 0.01 * torch.rand(shape[:-1], generator=gen, device="cuda")
            q8 = (k8, ks, v8, vs)
            q8d = tuple(torch.stack([tpa.gather_pages(t[l], table, n) for l in range(L)]) for t in q8)
            del k8, v8, ks, vs
        coords = (wpage, wrow)

        def sdpa(i):
            return F.scaled_dot_product_attention(q[:, :, None], kd[i % L][:, :, : p + 1], vd[i % L][:, :, : p + 1])

        kv_fp = esize * 2 * B * KVH * (p + 1) * hs
        kv_q8 = 2 * B * KVH * (p + 1) * (hs + 4)
        ops = 4 * hs * B * H * (p + 1)
        cases = (
            ("K15", "paged_decode_attention_stacked",
             lambda i: tpa.paged_decode_attention_stacked(q, kp, vp, table, kn, vn, *coords, i % L, pos),
             lambda i: tpa.paged_decode_attention_stacked_plain(q, kp, vp, table, kn, vn, *coords, i % L, pos),
             lambda i: fa.flash_decode_attention_stacked(q, kd, vd, kn, vn, i % L, pos), "K2",
             kv_fp + esize * (2 * B * H * hs + 2 * B * KVH * hs)),
            ("K16", "paged_decode_attention_q8_stacked",
             lambda i: tpa.paged_decode_attention_q8_stacked(q, *q8, table, k8n, ksn, v8n, vsn, *coords, i % L, pos),
             lambda i: tpa.paged_decode_attention_q8_stacked_plain(q, *q8, table, k8n, ksn, v8n, vsn, *coords,
                                                                   i % L, pos),
             lambda i: aq.flash_decode_attention_q8_stacked(q, *q8d, k8n, ksn, v8n, vsn, i % L, pos),
             "K8", kv_q8 + esize * 2 * B * H * hs + B * KVH * (2 * hs + 8)),
            ("K17", "paged_decode_attention_fused",
             lambda i: tpa.paged_decode_attention_fused(qkv, kp, vp, table, cos_il, sin_il, *coords, i % L, pos,
                                                        n_heads=H),
             lambda i: tpa.paged_decode_attention_fused_plain(qkv, kp, vp, table, cos_il, sin_il, *coords,
                                                              i % L, pos, H),
             lambda i: fa.flash_decode_attention_fused(qkv, kd, vd, cos_il, sin_il, i % L, pos, n_heads=H), "K4",
             kv_fp + esize * B * (H + 2 * KVH + H) * hs + 8 * B * hs),
            ("K18", "paged_decode_attention_q8_fused",
             lambda i: tpa.paged_decode_attention_q8_fused(qkv, *q8, table, cos_il, sin_il, *coords, i % L, pos,
                                                           n_heads=H),
             lambda i: tpa.paged_decode_attention_q8_fused_plain(qkv, *q8, table, cos_il, sin_il, *coords,
                                                                 i % L, pos, H),
             lambda i: aq.flash_decode_attention_q8_fused(qkv, *q8d, cos_il, sin_il, i % L, pos,
                                                          n_heads=H), "K9",
             kv_q8 + esize * B * (H + 2 * KVH + H) * hs + 8 * B * hs),
        )
        for tag, name, kern, plain, twin, twin_tag, nbytes in cases:
            if tag not in tags:
                continue
            got, want = kern(0)[0], plain(0)[0]
            torch.cuda.synchronize()
            if tag in ("K16", "K18"):
                qt = q if tag == "K16" else aq.rope_quantize_plain(qkv, cos_il, sin_il, H)[0]
                dense = [tpa.gather_pages(t[0], table, n) for t in q8]
                _, A, R = q8kv_terms(qt[:, None], *dense, pos.long()[:, None])
                err = compare(got, want, dtype, q8kv_tolerance(dtype, A[:, 0], R[:, 0]))
            else:
                err = compare(got, want, dtype)
            n_iter = 256 if p == 256 else 64
            ms, qk = time_ms(kern, n_iter, cycles_per_ms)
            plain_ms, qp = time_ms(plain, 4, cycles_per_ms, n_warm=1)
            twin_ms, qt_ = time_ms(twin, n_iter, cycles_per_ms)
            sdpa_ms, qs = time_ms(sdpa, n_iter, cycles_per_ms)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_FLOPS[dn] * 1e3
            bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
            say("time", kernel=f"{name}[{dn},B={B}]", pos=p, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                **{f"dense_twin_{twin_tag}_ms": f"{twin_ms:.4f}"},
                **{f"yardstick_SDPA_{dn}_cache_ms": f"{sdpa_ms:.4f}"},
                library_ms="none_(no_single_call)", bound_ms=f"{bound:.4f}", bound_by=by,
                share_of_bound=f"{bound / ms:.3f}",
                MB=f"{nbytes / 1e6:.2f}", GB_per_s=f"{nbytes / ms / 1e6:.0f}", max_abs_err=f"{err:.3e}",
                queued_kernel_plain_twin_sdpa=f"{qk},{qp},{qt_},{qs}")
            if sweep and tag == "K18" and p == S - 1 and hasattr(tpa, "q8_plan"):
                own = tpa.q8_plan(B, H, KVH, S, hs, aq._sms(torch.cuda.current_device()))["splits"]
                times = {}
                for sp in sorted({1, 2, 3, 4, 6, 8, own}):
                    times[sp] = time_ms(lambda i, sp=sp: tpa._q8_launch(
                        tpa.paged_decode_attention_q8_fused, "fused", qkv, q8, table, wpage, wrow, i % L, pos, H,
                        qkv=qkv, rope=(cos_il, sin_il), splits=sp), n_iter, cycles_per_ms)[0]
                say("tick-split", kernel=f"{name}[{dn},B={B}]", pos=p, plan_splits=own,
                    **{f"ms_at_{sp}": f"{t:.4f}" for sp, t in times.items()})
            if fp_sweep and tag == "K17" and p == S - 1:
                sms = aq._sms(torch.cuda.current_device())
                own = tpa.fp_plan(qkv, kp, vp, cos_il, sin_il, table, H, sms, True)["splits"]
                times = {}
                for sp in sorted({1, 2, 4, own}):
                    times[sp] = time_ms(lambda i, sp=sp: tpa._fp_launch(
                        tpa.paged_decode_attention_fused, qkv, kp, vp, cos_il, sin_il, table, wpage, wrow, i % L,
                        pos, H, splits=sp), n_iter, cycles_per_ms)[0]
                say("tick-split", kernel=f"{name}[{dn},B={B}]", pos=p, plan_splits=own,
                    **{f"ms_at_{sp}": f"{t:.4f}" for sp, t in times.items()})
            if p == 256:  # the kernel line's rows; full context is printed and kept in PERF.md
                rows.append({
                    "name": f"{name}[{dn},B={B}]", "route": "cuda", "source": src,
                    "replaces": f"llama2_tpu/ops/pallas/paged_attention.py:{PAGED_LINES[tag]}",
                    "launches": launches[tag], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": by, "library_ms": None,
                })
        del kp, vp, kd, vd, q8, q8d
        torch.cuda.empty_cache()
    return rows


def phase_timing_bench(tags=("K19", "K20", "K3", "K14"), sweep: bool = False) -> dict:
    """K3, K14, K19 and K20 (or ``tags``) at the kernel benchmarks' shapes,
    on the benchmark's own inputs (``llama2_tpu_torch/benchmarks/kernels.py``:
    the operands rotate through 512 MB or more, so no call finds them in the
    50 MB L2), beside the bound, the plain version and a library yardstick
    timed here only: ``scaled_dot_product_attention`` (``enable_gqa``) on the
    caches cut to pos + 1 for K3; SDPA on the same rows gathered into a
    dense cache ahead for K14 (as the K15 line); ``F.rms_norm`` for K19; for
    K20, which no single call computes, the composed ``F.silu(h1) * h3``.
    Bound: the case's bytes (each input read once, each output written once)
    over the memory rate, or its operations over the dtype's peak.
    ``sweep``: K3 at pos 8191 also at 1, 2, 4, 8 and 16
    splits and K14 at pos 4095 at 1, 2 and 4 (``read-split`` lines), where
    the tree has their ``splits`` hooks. Returns the kernel line's row for
    each, by tag, ``launches`` still to be filled from the benchmark run
    (phase 6)."""
    import torch
    import torch.nn.functional as F

    from llama2_tpu_torch.benchmarks import kernels as kb
    from llama2_tpu_torch.ops.cuda import attention as fa
    from llama2_tpu_torch.ops.cuda import paged_attention as tpa

    b = kb.Bench("cuda", seed=SEED + 16)
    rows = {}

    def split_sweep_read(name, case, counts, call):
        if not sweep:
            return
        if not (hasattr(fa, "launch_read") and hasattr(tpa, "_read_launch")):
            say("read-split", kernel=name, shape=case.name, splits="no_splits_hook_in_this_tree")
            return
        times = {n: b.time(lambda i, n=n: call(i, n), 64, case.copies) for n in counts}
        say("read-split", kernel=f"{name}[{dtype_name(case.dtype)}]", shape=case.name,
            **{f"ms_at_{n}": f"{t:.4f}" for n, (t, _) in times.items()},
            queued=",".join(str(q) for _, q in times.values()))

    def timed(tag, name, src, line, case, lib, lib_name, iters, dtype, tol=None, **extra):
        (_, kern, _), (_, plain, _) = case.variants[:2]
        err = compare(kern(0), plain(0), dtype, tol)
        ms, qk = b.time(kern, iters, case.copies)
        plain_ms, qp = b.time(plain, iters, case.copies, kernel=False)
        lib_ms, ql = b.time(lib, iters, case.copies)
        t_bytes = case.nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = case.flops / PEAK_FLOPS[dtype_name(case.dtype)] * 1e3
        bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        say("time", kernel=f"{name}[{dtype_name(case.dtype)}]", shape=case.name, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", **{f"{lib_name}_ms": f"{lib_ms:.4f}"}, bound_ms=f"{bound:.4f}",
            bound_by=by, MB=f"{case.nbytes / 1e6:.2f}", GB_per_s=f"{case.nbytes / ms / 1e6:.0f}",
            max_abs_err=f"{err:.3e}", rotation=case.copies, queued_kernel_plain_library=f"{qk},{qp},{ql}",
            **extra)
        if tag not in rows:  # the kernel line takes each kernel's first shape
            rows[tag] = {
                "name": f"{name}[{dtype_name(case.dtype)},{case.name[case.name.index('[') + 1:-1]}]",
                "route": "cuda", "source": src,
                "replaces": line, "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by,
                "library_ms": lib_ms if lib_name == "library" else None,
            }

    for R, D in ((256, 4096), (1024, 8192)) if "K19" in tags else ():
        c = kb.rmsnorm_case(b, R, D)
        x, w = c.inputs["x"], c.inputs["w"]
        timed("K19", "rmsnorm", "llama2_tpu_torch/csrc/rmsnorm.cu", "llama2_tpu/ops/pallas/rmsnorm.py:46",
              c, lambda i: F.rms_norm(x[i % c.copies], (D,), w, 1e-5), "library", 200, torch.float32,
              norm_tolerance(torch.float32), library_call="F.rms_norm")
    for R, D in ((256, 11008), (512, 11008)) if "K20" in tags else ():
        c = kb.swiglu_case(b, R, D)
        h1, h3 = c.inputs["h1"], c.inputs["h3"]
        timed("K20", "swiglu", "llama2_tpu_torch/csrc/swiglu.cu", "llama2_tpu/ops/pallas/swiglu.py:43",
              c, lambda i: F.silu(h1[i % c.copies]) * h3[i % c.copies], "composed_silu_mul", 200,
              torch.float32, library_ms="none_(no_single_call)")
    for S_, p in ((2048, 2047), (8192, 8191), (8192, 1023)) if "K3" in tags else ():
        c = kb.attention_case(b, S_, p)
        q4, k, v, posv = c.inputs["q"].transpose(1, 2), c.inputs["k"], c.inputs["v"], c.inputs["pos"]
        timed("K3", "flash_decode_attention", "llama2_tpu_torch/csrc/decode_attention.cu",
              "llama2_tpu/ops/pallas/attention.py:562", c,
              lambda i: F.scaled_dot_product_attention(q4, k[i % c.copies][:, :, : p + 1],
                                                       v[i % c.copies][:, :, : p + 1], enable_gqa=True),
              "library", 128, torch.float32, library_call="SDPA_enable_gqa")
        if p == 8191:
            q3, hs = c.inputs["q"][:, 0], c.inputs["q"].shape[-1]
            split_sweep_read("flash_decode_attention", c, (1, 2, 4, 8, 16), lambda i, n: fa.launch_read(
                q3, k[i % c.copies], v[i % c.copies], posv, 1.0 / hs**0.5, splits=n))
        del c, k, v
    for p in (256, S - 1) if "K14" in tags else ():
        c = kb.paged_cases(b, p)[0]
        t = c.inputs
        kd, vd = (torch.stack([tpa.gather_pages(pool[l], t["table"], t["n_used"]) for l in range(t["L"])])
                  for pool in (t["k"], t["v"]))
        q4 = t["q"][:, :, None]
        timed("K14", "paged_decode_attention", "llama2_tpu_torch/csrc/paged_attention.cu",
              "llama2_tpu/ops/pallas/paged_attention.py:150", c,
              lambda i: F.scaled_dot_product_attention(q4, kd[i % t["L"]][:, :, : p + 1],
                                                       vd[i % t["L"]][:, :, : p + 1]),
              "yardstick_SDPA_gathered", 64, torch.bfloat16, library_ms="none_(no_single_call)")
        if p == S - 1:
            hs = t["q"].shape[-1]
            split_sweep_read("paged_decode_attention", c, (1, 2, 4), lambda i, n: tpa._read_launch(
                t["q"], t["k"][i % t["L"]], t["v"][i % t["L"]], t["table"], t["pos"], 1.0 / hs**0.5, splits=n))
        del c, t, kd, vd
    torch.cuda.empty_cache()
    return rows


BENCH_LINE = re.compile(
    r"^(?P<name>.+?) +(?P<us>\d+\.\d+) us/op"
    r"(?: +(?P<gbs>\d+\.\d) GB/s +(?P<hbm>\d+\.\d)% of 3\.35 TB/s)?"
    r"(?: +(?P<tf>\d+\.\d+) TFLOP/s +(?P<peak>\d+\.\d)% of \d+ TFLOP/s)?(?P<gaps>  \[host gaps\])?$"
)


def bench_expected() -> list[str]:
    """The lines ``python -m llama2_tpu_torch.benchmarks.kernels all`` must
    print, by name: each suite's shapes and variants."""
    two = ("cuda", "plain")
    names = [f"rmsnorm[{r}x{d}] {v}" for r, d in ((256, 4096), (1024, 8192)) for v in two]
    names += [f"swiglu[{r}x11008] {v}" for r in (256, 512) for v in two]
    names += [f"q8matmul[{m}x4096x{n}] {v}" for m, n in ((1, 11008), (8, 11008), (1, 4096))
              for v in ("cuda fused", "torch dequant+matmul")]
    names += [f"attn[S{s},pos{p}] {v}" for s, p in ((2048, 2047), (8192, 8191), (8192, 1023)) for v in two]
    names += [f"attn-stacked[{k} B8 S2048,pos{p}] {v}" for k in ("f32", "int8") for p in (2040, 512)
              for v in two]
    names += [f"mlp-block[B8 4096x11008] {v}" for v in ("fused", "split")]
    names += [f"prefill[T2048,S{s}] {v}" for s in (2048, 8192) for v in two]
    names += [f"sample[32000] {v}" for v in ("argmax", "multinomial", "top_p 0.9 (full sort)")]
    names += [f"paged[K{k} B8 page256,pos{p}] {v}" for p in (256, 4095) for k in range(14, 19) for v in two]
    return names


def phase_bench(smi: str) -> dict:
    """The kernel benchmarks' entry point, this slice's path, as a user runs
    it: ``python -m llama2_tpu_torch.benchmarks.kernels all`` in a subprocess.
    It must exit 0, print the card's ``nvidia-smi`` line first, then every
    line of ``bench_expected`` and no other, none of them over 105% of the
    memory rate or of the peak it is read against, and last its launch
    counts (from 0 at its start): every kernel it runs at least once.
    Returns the launch counts by tag."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "llama2_tpu_torch.benchmarks.kernels", "all"],
                       capture_output=True, text=True, timeout=900, cwd=REPO)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"the kernel benchmarks exited {r.returncode}:\n{r.stderr[-4000:]}")
    lines = r.stdout.splitlines()
    if lines[0] != smi.splitlines()[0]:
        raise AssertionError(f"benchmark header {lines[0]!r}, not the card's {smi!r}")
    names = []
    for line in lines[1:-1]:
        say("bench", line=line)
        m = BENCH_LINE.match(line)
        if m is None:
            raise AssertionError(f"malformed benchmark line {line!r}")
        names.append(m["name"])
        for key in ("hbm", "peak"):
            if m[key] is not None and float(m[key]) > 105.0:
                raise AssertionError(f"impossible reading, {m[key]}% of the card's rate: {line!r}")
    if names != bench_expected():
        missing = sorted(set(bench_expected()) - set(names))
        raise AssertionError(f"benchmark lines differ from the expected ones; missing {missing}")
    launches = json.loads(lines[-1])["launches"]
    idle = sorted(tag for tag, n in launches.items() if n == 0)
    if idle:
        raise AssertionError(f"the kernel benchmarks never launched {idle}")
    say("bench", entry="python_-m_llama2_tpu_torch.benchmarks.kernels_all", exit=0, lines=len(names),
        seconds=f"{seconds:.1f}", launches=",".join(f"{t}:{n}" for t, n in launches.items()))
    return launches


def phase_read_timing(cycles_per_ms: float) -> None:
    """The read-only decode attention kernels alone, for comparing two trees
    in one call: ``python3 chip_smoke.py --read-timing`` runs it and nothing
    else. K3 at the kernel benchmarks' three shapes and K14 at pos 256 and
    4095, on the benchmark's rotated inputs (``phase_timing_bench``: beside
    the bound, the plain version and the yardstick), with K3 at pos 8191 at
    1, 2, 4, 8 and 16 splits and K14 at pos 4095 at 1, 2 and 4 where the tree
    has their ``splits`` hooks; then the appending kernels of the same split
    form, which a change to K3 or K14 must leave where they were: K2 and K4
    (bf16, 7B heads, 1 and 8 rows at pos 4095, call i on layer i % 4) and
    K15 and K17 (8 slots at pos 256 and 4095, ``phase_timing_paged``). It calls the
    wrappers by their public signatures (the sweep aside), so this script
    also times an older checkout: copy it into one and run it from that
    checkout's root, parent, this, this, parent."""
    import torch

    from llama2_tpu_torch.ops.cuda import attention as fa

    phase_timing_bench(("K3", "K14"), sweep=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    L, (H, KVH, hs), p = 4, LAYOUTS["7B"], S - 1
    for B in (1, 8):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

        kc, vc = randn(L, B, KVH, S, hs), randn(L, B, KVH, S, hs)
        q, qkv = randn(B, H, hs), randn(B, H + 2 * KVH, hs)
        kn, vn = randn(B, KVH, 1, hs), randn(B, KVH, 1, hs)
        pos = torch.full((B,), p, dtype=torch.int32, device="cuda")
        cos_il, sin_il = rope_tables(pos, hs)
        for tag, fn in (
            ("K2", lambda i: fa.flash_decode_attention_stacked(q, kc, vc, kn, vn, i % L, pos)),
            ("K4", lambda i: fa.flash_decode_attention_fused(qkv, kc, vc, cos_il, sin_il, i % L, pos, n_heads=H)),
        ):
            ms, queued = time_ms(fn, 64, cycles_per_ms)
            say("dense-time", kernel=tag, dtype="bf16", B=B, pos=p, ms=f"{ms:.4f}", queued=queued)
        del kc, vc
        torch.cuda.empty_cache()
    phase_timing_paged({"K15": 0, "K17": 0}, cycles_per_ms, tags=("K15", "K17"))


def phase_dense_timing(cycles_per_ms: float) -> None:
    """The dense decode attention kernels alone (K2, K4, K8, K9; bf16, the 7B
    head layout, 1 and 8 rows, every row at pos 256 and at 4095, call i on
    layer i % 4 of a 4-layer cache), then K2 and K4 at other split counts
    (``split_sweep``, ``dense-split`` lines), for comparing two trees in one call:
    ``python3 chip_smoke.py --dense-timing`` runs it and nothing else. Every
    tree since slice 5 has it: run each checkout's own script from its
    root."""
    import torch

    from llama2_tpu_torch.ops.cuda import attention as fa
    from llama2_tpu_torch.ops.cuda import attention_q8 as aq

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    L, (H, KVH, hs) = 4, LAYOUTS["7B"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B in (1, 8):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

        kc, vc = randn(L, B, KVH, S, hs), randn(L, B, KVH, S, hs)
        k8, ks = aq.quantize_kv_rows(kc.float())
        v8, vs = aq.quantize_kv_rows(vc.float())
        q, qkv = randn(B, H, hs), randn(B, H + 2 * KVH, hs)
        kn, vn = randn(B, KVH, 1, hs), randn(B, KVH, 1, hs)
        k8n, ksn = aq.quantize_kv_rows(kn.float())
        v8n, vsn = aq.quantize_kv_rows(vn.float())
        for p in (256, S - 1):
            pos = torch.full((B,), p, dtype=torch.int32, device="cuda")
            cos_il, sin_il = rope_tables(pos, hs)
            for tag, fn in (
                ("K2", lambda i: fa.flash_decode_attention_stacked(q, kc, vc, kn, vn, i % L, pos)),
                ("K4", lambda i: fa.flash_decode_attention_fused(qkv, kc, vc, cos_il, sin_il, i % L, pos,
                                                                 n_heads=H)),
                ("K8", lambda i: aq.flash_decode_attention_q8_stacked(q, k8, ks, v8, vs, k8n, ksn, v8n, vsn,
                                                                      i % L, pos)),
                ("K9", lambda i: aq.flash_decode_attention_q8_fused(qkv, k8, ks, v8, vs, cos_il, sin_il, i % L,
                                                                    pos, n_heads=H)),
            ):
                ms, queued = time_ms(fn, 256 if p == 256 else 64, cycles_per_ms)
                say("dense-time", kernel=tag, dtype="bf16", B=B, pos=p, ms=f"{ms:.4f}", queued=queued)
            split_sweep(fa.plan(B, H, KVH, S, hs, torch.bfloat16, sms)["splits"], B, p, {
                "K2": lambda i, n: fa.launch_stacked(q, kc, vc, kn, vn, i % L, pos, n),
                "K4": lambda i, n: fa.launch_fused(qkv, kc, vc, cos_il, sin_il, i % L, pos, H, n),
            }, cycles_per_ms)
        del kc, vc, k8, v8
        torch.cuda.empty_cache()


def split_sweep(own: int, B: int, p: int, calls: dict, cycles_per_ms: float) -> None:
    """K2 and K4 (``calls[tag](i, splits)``: call i at that split count, on
    bf16 caches of B rows, every row at ``p``) at other split counts than
    their plan's (``own``), the plan's own among them: the readings
    ``attention.BLOCKS_PER_SM`` rests on."""
    for n in ((1, 4, 6, 8, 9, 12, 16) if B == 1 else (1, 2, 4)):
        for tag, fn in calls.items():
            ms, queued = time_ms(lambda i: fn(i, n), 256 if p == 256 else 64, cycles_per_ms)
            say("dense-split", kernel=tag, dtype="bf16", B=B, pos=p, splits=n, planned=own,
                ms=f"{ms:.4f}", queued=queued)


def host_us_per_call(fn, n_iter: int, cycles_per_ms: float, rounds: int = 7) -> float:
    """The host's microseconds a call of ``fn(i)``: the least over ``rounds``
    rounds of ``n_iter`` calls, each round issued while a device sleep holds
    the stream (so no call waits on the device), after three warm-up calls.
    The least round is the one the host's other work disturbed least."""
    import torch

    for i in range(3):
        fn(i)
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(50 * cycles_per_ms))  # 50 ms: longer than the calls take to issue
        t0 = time.perf_counter()
        for i in range(n_iter):
            fn(i)
        best = min(best, (time.perf_counter() - t0) * 1e6 / n_iter)
    torch.cuda.synchronize()
    return best


def phase_decode_timing(cycles_per_ms: float) -> None:
    """Single-stream decode on slice 3's main path (Q8 weights, bf16
    activations, the two-launch layer over the fp cache, 7B width, 32 layers:
    ``q8/bf16/cuda/two-launch/32L``) at positions 201-264, for comparing two
    trees in one call: ``python3 chip_smoke.py --decode-timing`` runs it and
    nothing else; to run it on another tree, copy this script into that
    tree's root. ``decode-time`` lines: K4 alone at batch 1 and pos 256 (its
    device ms a call, and the host's microseconds a call of its wrapper);
    the decode tok/s of five greedy generations of the 200-token prompt
    plus 64 tokens; then the profile of the decode steps at positions
    201-264 (wall, device and host ms a step)."""
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io.convert import random_q8_params
    from llama2_tpu_torch.ops.cuda import attention as fa
    from llama2_tpu_torch.runtime.generator import Generator

    L, (H, KVH, hs) = 32, LAYOUTS["7B"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    kc, vc = (torch.randn((L, 1, KVH, S, hs), generator=gen, device="cuda").to(torch.bfloat16) for _ in "kv")
    qkv = torch.randn((1, H + 2 * KVH, hs), generator=gen, device="cuda").to(torch.bfloat16)
    pos = torch.tensor([256], dtype=torch.int32, device="cuda")
    cos_il, sin_il = rope_tables(pos, hs)

    def k4(i):
        return fa.flash_decode_attention_fused(qkv, kc, vc, cos_il, sin_il, i % L, pos, n_heads=H)

    ms, queued = time_ms(k4, 256, cycles_per_ms)
    say("decode-time", kernel="K4", dtype="bf16", B=1, pos=256, ms=f"{ms:.4f}", queued=queued,
        host_us_per_call=f"{host_us_per_call(k4, 256, cycles_per_ms):.2f}")
    del kc, vc
    torch.cuda.empty_cache()

    config = config_7b(32)
    dn = "q8/bf16/cuda/two-launch/32L"
    g = Generator(config, random_q8_params(config, SEED, "cuda", torch.bfloat16, group_size=GROUP),
                  dtype=torch.bfloat16, backend="cuda", device="cuda")
    prompt = prompt_tokens()
    g.generate(prompt[:20], GenerationConfig(temperature=0.0, steps=22))  # warm-up
    for rep in range(5):
        res = g.generate(prompt, GenerationConfig(temperature=0.0, steps=len(prompt) + GEN_TOKENS))
        n_gen = len(res.tokens) - len(prompt)
        say("decode-time", path=dn, rep=rep, prompt_tokens=len(prompt), generated=n_gen,
            ttft_ms=f"{res.ttft_s * 1e3:.2f}", decode_tok_s=f"{n_gen / (res.total_s - res.ttft_s):.2f}")
    long_context_profile(g, config, dn, steps=GEN_TOKENS, pos0=len(prompt) + 1)


def phase_prefill_timing(cycles_per_ms: float) -> None:
    """The prefill segment's kernels alone, for comparing two trees in one
    call: ``python3 chip_smoke.py --prefill-timing`` runs it and nothing else.
    K1 in bf16 and fp32 at the 7B head layout: T = 201 from pos 0 (the main
    path's chunk), T = 128 at pos 256 (a served chunk after a prefix hit) and
    T = 2048 from pos 0 (fp32 also T = 5 ending at the cache's last row, a
    verify window), call i on layer i % 32 of 32 layers' caches; K5/K6
    fast (bf16 activations) and accurate (fp32) at M = 201 on every Q8_SHAPES
    weight, call i on layer i % 32 of a 32-layer stack, and fast with the
    rmsnorm prologue on wqkv and w13 (the main path's form). Each beside its
    bound (phase 5's; fp32 K1 and accurate mode's float32-accurate bound on
    the tensor cores, ``accurate_ops_ms``, with the float32 SIMT bound
    beside it), its plain version and its library yardstick: SDPA
    (lower-right causal past pos 0) and ``torch.matmul`` on the weight
    dequantized ahead. It calls the wrappers by their public signatures
    only, so this script also times an older checkout: copy it into one and
    run it from that checkout's root."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from llama2_tpu_torch.io.convert import random_q8_params
    from llama2_tpu_torch.ops.cuda.prefill_attention import (
        flash_prefill_attention,
        flash_prefill_attention_plain,
    )
    from llama2_tpu_torch.ops.cuda.quant_matmul import (
        quant_matmul,
        quant_matmul_plain,
        quant_matmul_stacked,
        quant_matmul_stacked_plain,
    )
    from llama2_tpu_torch.quant.q8 import dequantize

    L, B, (H, KVH, hs) = 32, 1, LAYOUTS["7B"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    for dtype in (torch.bfloat16, torch.float32):
        dn = dtype_name(dtype)
        esize = torch.tensor([], dtype=dtype).element_size()
        kc = torch.randn((L, B, KVH, S, hs), generator=gen, device="cuda").to(dtype)
        vc = torch.randn((L, B, KVH, S, hs), generator=gen, device="cuda").to(dtype)
        segments = [(PROMPT_TOKENS + 1, 0), (128, 256), (2048, 0)]
        if dtype == torch.float32:  # a verify window at the end of the cache
            segments.append((5, S - 5))
        for T, pos0 in segments:
            q = torch.randn((L, B, T, H, hs), generator=gen, device="cuda").to(dtype)
            n = pos0 + T
            mask = causal_lower_right(T, n)
            err = compare(flash_prefill_attention(q[0], kc[0], vc[0], pos0),
                          flash_prefill_attention_plain(q[0], kc[0], vc[0], pos0), dtype)
            many = 8 if T > 256 else 64
            ms, qk = time_ms(lambda i: flash_prefill_attention(q[i % L], kc[i % L], vc[i % L], pos0),
                             many, cycles_per_ms)
            plain_ms, qp = time_ms(
                lambda i: flash_prefill_attention_plain(q[i % L], kc[i % L], vc[i % L], pos0),
                4 if T > 256 else 16, cycles_per_ms, n_warm=1)
            lib_ms, ql = time_ms(
                lambda i: F.scaled_dot_product_attention(
                    q[i % L].transpose(1, 2), kc[i % L][:, :, :n], vc[i % L][:, :, :n], attn_mask=mask
                ), many, cycles_per_ms)
            vis = B * H * sum(pos0 + t + 1 for t in range(T))  # (query, key) pairs seen
            t_bytes = esize * (2 * B * T * H * hs + 2 * B * KVH * n * hs) / HBM_BYTES_PER_S * 1e3
            f32 = dtype == torch.float32
            t_ops = accurate_ops_ms(4 * hs * vis, "tf32") if f32 else 4 * hs * vis / PEAK_FLOPS[dn] * 1e3
            simt = {"bound_ms_f32_simt": f"{max(t_bytes, 4 * hs * vis / PEAK_FLOPS['f32'] * 1e3):.4f}"}
            say("prefill-time", kernel=f"K1[{dn}]", T=T, pos0=pos0, ms=f"{ms:.4f}",
                plain_ms=f"{plain_ms:.4f}", library_ms_sdpa=f"{lib_ms:.4f}",
                bound_ms=f"{max(t_bytes, t_ops):.4f}",
                bound_by="bytes" if t_bytes >= t_ops else "operations", **(simt if f32 else {}),
                TFLOP_per_s=f"{4 * hs * vis / ms / 1e9:.2f}", max_abs_err=f"{err:.3e}",
                queued_kernel_plain_library=f"{qk},{qp},{ql}")
            del q
        del kc, vc
        torch.cuda.empty_cache()

    params = all_layouts(random_q8_params(config_7b(L), SEED + 16, "cuda", torch.bfloat16, group_size=GROUP))
    M = PROMPT_TOKENS + 1
    cases = [(mode, name, False) for mode in ("fast", "accurate") for name in Q8_SHAPES]
    cases[6:6] = [("fast", "wqkv", True), ("fast", "w13", True)]
    for mode, name, norm in cases:
        dtype = torch.bfloat16 if mode == "fast" else torch.float32
        dn = dtype_name(dtype)
        esize = torch.tensor([], dtype=dtype).element_size()
        K, N = Q8_SHAPES[name]
        w = params[name]
        stacked = w.q.ndim == 3
        x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
        kw = {"rms_w": (1 + 0.1 * torch.randn(K, generator=gen, device="cuda")).to(dtype)} if norm else {}
        # the yardstick's weights: 4 layers dequantized ahead (more than L2 holds)
        wd = dequantize(w[:4], dtype) if stacked else dequantize(w, dtype)[None]
        if stacked:
            def kern(i): return quant_matmul_stacked(x, w, i % L, mode=mode, **kw)
            def plain(i): return quant_matmul_stacked_plain(x, w, i % L, mode=mode, **kw)
        else:
            def kern(i): return quant_matmul(x, w, mode=mode)
            def plain(i): return quant_matmul_plain(x, w, mode=mode)
        def lib(i): return torch.matmul(x, wd[i % wd.shape[0]])
        err = compare(kern(0), plain(0), dtype, q8_tolerance(dtype, mode, norm))
        ms, qk = time_ms(kern, 16, cycles_per_ms)
        plain_ms, qp = time_ms(plain, 4, cycles_per_ms, n_warm=1)
        lib_ms, ql = time_ms(lib, 16, cycles_per_ms)
        nbytes = K * N + 4 * (K // GROUP) * N + esize * (M * K + M * N)
        t_bytes, t_ops, simt = q8_bounds_ms(M, K, N, mode, nbytes)
        say("prefill-time", kernel=f"{'K6' if stacked else 'K5'}[{dn},{mode}]", weight=name,
            prologue=norm, M=M, K=K, N=N, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms_matmul_on_dequantized=f"{lib_ms:.4f}", bound_ms=f"{max(t_bytes, t_ops):.4f}",
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            **({"bound_ms_f32_simt": f"{max(t_bytes, simt):.4f}"} if simt else {}),
            TFLOP_per_s=f"{2 * M * K * N / ms / 1e9:.2f}", max_abs_err=f"{err:.3e}",
            queued_kernel_plain_library=f"{qk},{qp},{ql}")
        del wd
    del params
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say("card", name=name.replace(" ", "_"), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    t_start = time.perf_counter()
    phase_build()
    if sys.argv[1:] == ["--dense-timing"]:
        phase_dense_timing(warm_cycles_per_ms())
        print(smi)
        return 0
    if sys.argv[1:] == ["--decode-timing"]:
        phase_decode_timing(warm_cycles_per_ms())
        print(smi)
        return 0
    if sys.argv[1:] == ["--prefill-timing"]:
        phase_prefill_timing(warm_cycles_per_ms())
        print(smi)
        return 0
    if sys.argv[1:] == ["--tick-timing"]:
        phase_tick_timing(warm_cycles_per_ms())
        print(smi)
        return 0
    if sys.argv[1:] == ["--serve-timing"]:
        phase_serve_timing()
        print(smi)
        return 0
    if sys.argv[1:] == ["--read-timing"]:
        phase_read_timing(warm_cycles_per_ms())
        print(smi)
        return 0
    if sys.argv[1:] == ["--q8kv-timing"]:
        phase_q8kv_timing(warm_cycles_per_ms())
        print(smi)
        return 0
    phase_kernels()
    phase_kernels_q8()
    phase_kernels_mlp()
    phase_kernels_q8kv()
    phase_kernels_batch8()
    phase_kernels_paged()
    phase_kernels_bench()
    # this slice's main path, served: the paged engine over both pools
    served = {kv: phase_serve(kv) for kv in (False, True)}
    accurate = {kv: phase_serve_accurate(kv) for kv in (False, True)}
    # the fp-cache main path of slice 3, then this slice's: the int8 cache
    fast = phase_generate_q8("two-launch", "cuda", torch.bfloat16, speculative=True)
    q8_launches = {
        "fast": fast,
        "int8kv": phase_generate_q8("int8kv", "cuda", torch.bfloat16, speculative=True,
                                    fp_stream=fast["tokens"]),
        # the route K13 replaces, at the main path's depth: both end to end
        "int8kv-two-launch": phase_generate_q8("int8kv-two-launch", "cuda", torch.bfloat16),
        # fp32 activations keep T = 1 and T = 4 logits close: the spec check
        # covers most positions there
        "int8kv-accurate": phase_generate_q8("int8kv-accurate", "cuda-accurate", torch.float32, 8,
                                             speculative=True),
        "int8kv-fp": phase_generate_q8("int8kv-fp", "cuda", torch.bfloat16, 8),
        "fast-f32": phase_generate_q8("two-launch", "cuda", torch.float32, 8),
        "composed": phase_generate_q8("composed", "cuda", torch.bfloat16, 8),
        "ffn-only": phase_generate_q8("ffn-only", "cuda", torch.bfloat16, 2),
        "accurate": phase_generate_q8("accurate", "cuda-accurate", torch.float32, speculative=True),
        # the 8-row megakernels: the served runs over both pools (K11, K12),
        # the dense engine over the int8 cache (K13)
        "served": {"K12": served[False]["K12"] + served[True]["K12"],
                   "K11": served[False]["K11"] + served[True]["K11"], "K13": served[True]["dense-K13"]},
    }
    launches = {}
    for dtype in (torch.bfloat16, torch.float32):
        launches[dtype] = phase_generate(dtype, 8)
    phase_cli()
    kernels = []
    cycles_per_ms = warm_cycles_per_ms()
    for dtype in (torch.bfloat16, torch.float32):
        kernels += phase_timing(dtype, launches[dtype], cycles_per_ms)
    kernels += phase_timing_q8(q8_launches, cycles_per_ms)
    kernels += phase_timing_paged({"K15": accurate[False]["K15"], "K16": accurate[True]["K16"],
                                   "K17": served[False]["K17"], "K18": served[True]["K18"]}, cycles_per_ms)
    # K15's launches on a served path are over an fp32 pool
    kernels += phase_timing_paged({"K15": accurate[False]["K15"]}, cycles_per_ms, tags=("K15",),
                                  dtype=torch.float32)
    bench_rows = phase_timing_bench()
    # this slice's path: the kernel benchmarks' entry point, counted in its own process
    bench_launches = phase_bench(smi)
    for tag in ("K3", "K14", "K19", "K20"):
        kernels.append({**bench_rows[tag], "launches": bench_launches[tag]})
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
