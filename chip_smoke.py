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
3. the served path, slice 5's main path: ``PagedBatchEngine`` at full
   Llama-2-7B width, INT8 weights, bf16 activations,
   ``backend="cuda"``, 8 slots, 256-row pages, the prefix cache, serving 16
   requests over a bf16 page pool and an int8 one at 4 layers (8 in slices
   17-18; the bf16 pool at 32 before slice 17),
   with the launches of
   every decode tick asserted (K6 1, K17 or K18 32, K12 31, K11 1, K5 1)
   and every admission prefill's K1 through its tensor-core variant (bf16's
   and, on ``cuda-accurate``, fp32's), every K12 and K11 of a tick (and K13
   of the dense engine's) on the megakernels' tensor-core form, reruns and
   pipeline depth 1 against 2 bit-equal,
   the greedy streams held to their plain replays, ticks profiled at short
   and long positions, and
   the dense ``BatchEngine`` on the same requests for its memory;
   ``cuda-accurate`` in fp32 at 4 layers over both pools (K15, K16; 8
   before slice 19);
   engine-level speculation (``spec_window=4``) on the 12 greedy requests
   through the paged engine over a bf16 pool (16 layers) and the dense
   engine over the int8 cache (8 layers), then in fp32 at 4 layers on
   ``cuda`` and ``cuda-accurate``, every window's launches asserted
   (K6 and K5 on the M > 8 tile; no decode attention kernel), the
   streams held to the same engine's plain tick by the speculative margin
   rule, served and decode tok/s, tokens and wall / device ms a window
   beside the plain tick's (``phase_serve_spec``). Then
   the earlier main paths: ``Generator.generate`` at full Llama-2-7B width (random
   weights from a seed, built on the card), a ~200-token prompt and 64 greedy
   tokens. INT8 (Q8) weights, ``backend="cuda"``, bf16 activations, 8
   layers (16 in slices 17-18, 32 before): over the fp cache (the 2-launch decode layer: glue-fused attention
   + the wo/FFN/next-QKV megakernel) and over the int8 KV cache (this slice's
   main path: one whole-layer launch a layer), each also with speculative
   decoding (4-token verify windows), and over the int8 cache with the
   whole-layer kernel switched off (K9 + K12), the first two profiled at
   positions 0-16 and 4080-4095. Over 8 layers: ``cuda-accurate`` in fp32 over the
   fp cache, with speculative decoding (its 32-layer prefill chunk runs in
   the perplexity phase); the int8 cache's other routes
   (``cuda-accurate`` in fp32 with K8, with speculative decoding; bf16
   weights with K8), fp32 activations on the 2-launch route and the composed
   dequant-matmul route (the ``w13`` layout); a 2-layer model whose ``wo``
   is left in bf16, which takes the FFN-only megakernel. bf16 and fp32
   weights: ``backend="cuda"``, 4 layers (8 before slice 19). Each with launch counts per
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
   INT8 file with ``--kv-cache int8 --spec 4``, against
   ``Generator.generate`` in this process; and the HTTP server
   (``python -m llama2_tpu_torch.runtime.server ... --quant int8 --paged``)
   as a subprocess, its greedy answers equal to an in-process paged engine's
   with its settings and held to ``Generator.generate`` by the margin rule
   (``hold_server_streams``), and the server with ``--spec 4``, its greedy
   answers equal to an in-process speculative paged engine's;
   then this slice's path, the tools and the host surface: the INT8
   perplexity gate (``tools/perplexity.py`` at 7B width and 32 layers on a
   512-token seeded corpus, chunk 256, the classifier K5 on its M > 8 tile
   at M = 256: ``cuda-accurate`` against the plain path, bf16 ``cuda``
   against fp32 by the bf16 rule, Q8 against the fp32 weights it came from
   at the JAX gate's fixture and at 7B; ``phase_perplexity``); a Hugging Face
   directory at 7B width and 2 layers written here (bf16 safetensors, two
   shards) imported by ``tools/import_hf.py`` to a ``.bin`` and an INT8
   param cache, the params exact, the CLI on both printing the same bytes,
   and with ``--profile`` the same bytes and a trace holding K13's and K5's
   events at their launch counts; the C++ tokenizer against the Python one;
   the server's ``--precompile`` cold start from an empty ``build/``
   (``phase_tools``); then slice 17's path, tensor- and data-parallel
   serving: ``BatchEngine(mesh=)`` in two or four ranks on the one card
   (gloo, the backend rule printed) at 7B width with random INT8 weights
   written once as a param cache that each rank loads its slices of, 1x2 at
   32 layers over both caches, 2x2 and a speculative 1x2 leg at 2 layers,
   every decode tick's launches asserted on every rank (K6 twice, K4 or K9
   and K10 with ``residual=False`` a layer, K5 once on the 16000-column
   vocab slice), the streams held to the one-card engine by the margin
   rule, tick ms and the reduces' share; and the server with ``--mesh 1x2``
   (``phase_mesh``); slice 18's paged engine over the mesh and the ring
   collective matmul (``phase_mesh_paged``); then slice 19's path, the last
   JAX families, every rank on the one card over gloo at 7B width in fp32
   (``phase_long_context``): ring attention and ``sp_prefill`` over a
   ``seq`` axis against the one-card attention and ``forward``, the
   sequence-sharded decoder (``--seq-shards``) over a 2040-token prompt
   whose cache crosses row 2048, greedy and sampled, against the one-card
   ``Generator``, ``pp_prefill`` / ``pp_decode`` over two stages, then four
   ranks with ``model`` beside ``seq`` and ``stage``, and the CLI's
   ``--seq-shards 2`` against its plain run, with a dropped ring hop and a
   misplaced KV append planted (no kernel is on these paths);
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
``{"ok": true, "device": {...}}``. ``python3 chip_smoke.py --tools`` builds
the kernels and runs only slice 16's phases (``phase_perplexity``,
``phase_tools``), ``--mesh`` only slice 17's and 18's (``phase_mesh``,
``phase_mesh_paged``), ``--long-context`` only slice 19's
(``phase_long_context``); ``--dense-timing``
builds the kernels and times only the dense decode attention kernels,
``--prefill-timing`` only the prefill segment's K1, K5 and K6,
``--decode-timing`` only single-stream decode on the two-launch route at
positions 201-264, with K4's host time a call, ``--tick-timing`` only
the served decode tick's kernels (K10-K13 at 8 rows, K15-K18),
``--serve-timing`` only the served bf16-pool path (a timed serving and the
tick profiles), ``--q8kv-timing`` only the int8-cache decode step's
kernels (K7-K9 and K13 at 1 and 8 rows, beside the K9 + K12 pair, and a
split-count sweep), ``--read-timing`` only the read-only decode
attention kernels (K3, K14, their split sweeps, and K2/K4/K15/K17 at pos
4095), ``--norm-timing`` only K19 beside ``F.rms_norm``, an empty launch
and a copy of the same bytes, and ``--window-timing`` only K5/K6 at the
served tick's 8 rows and the speculative window's 32 (to compare two checkouts in one call,
see ``phase_dense_timing``, ``phase_prefill_timing``,
``phase_decode_timing``, ``phase_tick_timing``, ``phase_serve_timing``,
``phase_q8kv_timing``, ``phase_read_timing`` and ``phase_norm_timing``). Without a CUDA device, or outside a checkout
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
    "7B/tp2": (16, 16, 128, False),  # a rank's heads at tp = 2 (phase_mesh)
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
    theirs at the five 7B shapes and at a rank's slices of wqkv, wo, w2 and
    wcls at tp = 2 (``parallel/sharding.py::shard_params``: N 6144, K 2048,
    K 5504, N 16000, the shapes ``phase_mesh`` gives them), M = 1, 8, 9, 32
    and 201, both modes, fp32 and bf16 activations, with and without
    prologue and epilogue, on layers 0 and 31 of 32-layer stacks."""
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
    from llama2_tpu_torch.parallel.sharding import shard_params

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
    # rank 1's slices at tp = 2: column-parallel wqkv and wcls, row-parallel wo and w2
    tp2 = shard_params({k: params[k] for k in ("wqkv", "wo", "w2", "wcls")}, (1, 2), coord=(0, 1))
    cases = [(name, name, params[name]) for name in Q8_SHAPES] + [(name, f"{name}/tp2", tp2[name]) for name in tp2]
    combos = ((0, False, False), (31, True, False), (31, False, True), (0, True, True))
    # decode rows, and the M > 8 tile just past them, at a speculative window
    # (8 slots x 4 tokens) and at the chunk
    m_rows = (1, 8, 9, 32, 201)
    for dtype in (torch.float32, torch.bfloat16):
        for mode in ("accurate", "fast"):
            for name, label, wt in cases:
                K, N = wt.q.shape[-2:]
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
                            got = quant_matmul(x, wt, mode=mode)
                            want = quant_matmul_plain(x, wt, mode=mode)
                        else:
                            got = quant_matmul_stacked(x, wt, layer, **kw)
                            want = quant_matmul_stacked_plain(x, wt, layer, **kw)
                        if getattr(fn, f"launches_tile_{mode}") != tiles + (M > 8):
                            raise AssertionError(f"{name} {mode} M={M}: the M > 8 tile count moved wrongly")
                        torch.cuda.synchronize()
                        err = compare(got, want, dtype, q8_tolerance(dtype, mode, norm))
                        worst[M] = max(worst.get(M, 0.0), err)
                say("K5" if name == "wcls" else "K6", dtype=dtype_name(dtype), mode=mode,
                    weight=label, K=K, N=N,
                    max_abs_err_M1_M8_M9_M32_M201=",".join(f"{worst[M]:.3e}" for M in m_rows),
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
    del params, tp2, cases
    torch.cuda.empty_cache()


def phase_kernels_mlp() -> None:
    """K10, K11, K12 against their plain versions: the 7B widths and the two
    ragged shapes; 1, 2, 3, 4, 5, 8, 12, 16 and 32 rows; fp32 and bf16 activations;
    layers 0, L-2 and L-1 of a stack (K12 reads the next layer's norm and QKV
    weights, clamped at the last); K10 with and without the residual. Every
    call is one launch in the form ``mlp_block.variant`` names (the
    tensor-core form for 3 or more rows at group 64; past 8 rows passes of
    8, the last one shorter; the first ragged shape's group of 8 keeps the FMA form), and a
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
            for M in (1, 2, 3, 4, 5, 8, 12, 16, 32):
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
    # K10 as a rank runs it at tp = 2 (phase_mesh): D 4096, HD/tp = 5504 (86
    # groups of 64), after the wo all-reduce without its residual; the rows
    # of a tick (8) and of the one-token chunks (1), and the forms between
    D, HD = 4096, 11008 // 2
    w1, w3, w2 = qt(L, D, HD, GROUP, 1.0), qt(L, D, HD, GROUP, 1.0), qt(L, HD, D, GROUP, 1.0)
    for dtype in (torch.float32, torch.bfloat16):
        rms_ffn = 1 + 0.1 * randn(L, D, dtype=dtype)
        worst, forms = (0.0, 0.0), set()
        for M in (1, 2, 3, 4, 5, 8):
            form[0] = mb.variant(M, D, HD, 0, (0, GROUP, GROUP, 0))
            forms.add(f"M{M}:{form[0]}")
            x = randn(M, D, dtype=dtype)
            for layer in (0, L - 1):
                r0 = mb.mlp_block_stacked.launches_no_residual
                got = once(mb.mlp_block_stacked, x, rms_ffn[layer], w1, w3, w2, layer, residual=False)
                if mb.mlp_block_stacked.launches_no_residual != r0 + 2:
                    raise AssertionError("K10 residual=False: not counted in launches_no_residual")
                want = mb.mlp_block_plain(x, rms_ffn[layer], w1, w3, w2, layer, residual=False)
                torch.cuda.synchronize()
                err = compare(got, want, dtype, mlp_tolerance(dtype, want))
                worst = max(worst, (err, err / float(want.float().abs().max())))
        say("K10-K12", kernel="K10/tp2", dtype=dtype_name(dtype), D=D, HD=HD, G=GROUP, residual=False,
            forms=",".join(sorted(forms)), layers=f"0,{L - 1}", bits="equal_on_rerun",
            tol="rtol=%g,atol=2e-3*max|want|" % mlp_tolerance(dtype, x)[0],
            K10_max_abs_err=f"{worst[0]:.3e}", K10_err_over_max=f"{worst[1]:.2e}")
    del w1, w3, w2
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
        # and a rank's 16 heads at tp = 2 (phase_mesh)
        for lname, (H, KVH, hs) in (("7B", LAYOUTS["7B"]), ("GQA", LAYOUTS["GQA"]), ("7B/tp2", (16, 16, 128))):
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
    pages of 256 and 128 rows, the 7B and a GQA head layout and a tp = 2
    rank's shard of the 7B one (16 heads, 16-head pools), layers 0 and 31
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

    # and a rank's shard at tp = 2 (16 heads over a 16-head pool, the table
    # of its local page ids: the paged mesh path's, phase_mesh_paged)
    for lname in ("7B", "GQA", "7B/tp2"):
        H, KVH, hs = {**LAYOUTS, "7B/tp2": SPLIT_CASES["7B/tp2"][:3]}[lname]
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
# JAX tests' ragged ones (288, 64, 172 wide; 768, 64, 172). K19's also sit
# on the edges of its register form's tiers (``rmsnorm.plan``: 32, 64, 128
# and 256 threads a row, 8 vectors a thread): f32 rows of 1024, 2048, 4096
# and 8192 fill a tier, 1028, 2052, 4100 are one vector past one, 8196 is
# too long for any (the loop form); bf16 the same at 2048-16384 and 2056,
# 4104, 8200 and 16392 (ragged in f32 widths: 1028 in bf16 is the scalar
# form); 4098 is ragged in both (the scalar form); R = 1 and R = 3
NORM_SHAPES = ((256, 4096), (1024, 8192), (1, 1, 288), (2, 7, 64), (1, 300, 172),
               (3, 1024), (1, 1028), (3, 2048), (1, 2052), (1, 4096), (3, 4100), (3, 8192),
               (1, 8196), (1, 2056), (3, 4104), (1, 8200), (3, 16384), (1, 16392), (3, 4098),
               (300, 256))
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
    from llama2_tpu_torch.ops.cuda.rmsnorm import plan as rms_plan
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
        # an unaligned view (one element in): the scalar form
        for shape, view in [(s, False) for s in NORM_SHAPES] + [((2, 4096), True)]:
            if view:
                x = randn(2 * 4096 + 1, dtype=dtype)[1:].view(*shape)
            else:
                x = randn(*shape, dtype=dtype)
            R = x.numel() // shape[-1]
            for wdt in dict.fromkeys((dtype, torch.float32)):
                w = 1 + 0.1 * randn(shape[-1], dtype=wdt)
                form = rms_plan(R, shape[-1], dtype, not view, torch.cuda.get_device_properties(0)
                                .multi_processor_count)
                n_form = getattr(rmsnorm, f"launches_{form['form']}")
                got = launched(rmsnorm, x, w)
                if getattr(rmsnorm, f"launches_{form['form']}") != n_form + 1:
                    raise AssertionError(f"K19 {shape}: not launched in the {form['form']} form")
                if got.dtype != dtype or got.shape != x.shape:
                    raise AssertionError(f"K19 gave {got.dtype} {tuple(got.shape)} for {dtype} rows")
                err = compare(got, rmsnorm_plain(x, w), dtype, (nrtol, natol))
                say("K19", dtype=dn, weight=dtype_name(wdt), shape="x".join(map(str, shape)),
                    view="unaligned" if view else "contiguous", form=form["form"], threads_a_row=form["tpr"],
                    rows_a_block=form["rows"], out_dtype=dtype_name(got.dtype), max_abs_err=f"{err:.3e}",
                    rtol=nrtol, atol=natol)
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
                      speculative: bool = False, fp_stream=None, profile: bool = False) -> dict:
    """One route of the INT8-weight path at full 7B width: generate, count
    launches, replay teacher-forced through the plain path; with ``profile``
    (on ``cuda``), profile decode steps at positions 0-16 and 4080-4095; with
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
        return _generate_q8(g, config, route, backend, dtype, dn, kv_quant, speculative, fp_stream, profile)
    finally:
        model.layer_block_supported = supported


def _generate_q8(g, config, route, backend, dtype, dn, kv_quant, speculative, fp_stream, profile) -> dict:
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
    if profile and backend == "cuda":
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


def served_run(eng, reqs, log: bool = False, check=None) -> dict:
    """Serve ``reqs`` on ``eng``, all submitted at once and driven to idle,
    with every launch counter set to 0 just before and read just after; each
    decode tick's launches recorded apart (admission prefills launch too),
    and each speculative window's (ticks_per_sync 1: a speculative tick is
    one window) under "windows", with its host wall seconds and seated
    slots. With ``log``, every sampled logits row is kept on the device and
    copied once at the end, per request in generated order: its first
    token's, then one a plain tick it was seated in (meant for pipeline
    depth 1, where each such row gives the request's next token), or the
    rows behind the tokens a window committed. ``check(eng, seg, pos)``, if
    given, is called before each window's forward and returns None or two
    functions: one run before the forward, one after it on the window's (B,
    d, V) logits; their time, with the device work they queue, is left out
    of every time returned and reported as ``check_s``."""
    import torch

    from llama2_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_stacked
    from llama2_tpu_torch.runtime import batch_engine as be

    wrappers = {**count_launches(), "K6-tile": VariantCount(quant_matmul_stacked, "launches_tile_fast"),
                "K5-tile": VariantCount(quant_matmul, "launches_tile_fast"),
                "K5-tile-acc": VariantCount(quant_matmul, "launches_tile_accurate")}
    ticks, windows, walls, slots, rows = [], [], [], [], {}
    spent = {"admit": 0.0, "check": 0.0}
    dispatch, spec_tick, spec_forward, start, sample, sample_first = (
        eng._dispatch_tick, eng._spec_tick, eng._spec_forward, eng._start_request, eng._sample,
        eng._sample_first)
    logits_from_hidden = be.logits_from_hidden
    window = {}  # the window in flight: its logits and the check's verdict on them

    def counted(fn, out, *args):
        before = {k: w.launches for k, w in wrappers.items()}
        fn(*args)
        out.append({k: w.launches - before[k] for k, w in wrappers.items()})

    def timed(what, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        spent[what] += time.perf_counter() - t0
        return out

    def counted_spec_tick():
        seated = [(b, r, len(r.tokens)) for b, r in enumerate(eng.slots) if r is not None]
        check0, t0 = spent["check"], time.perf_counter()
        be.logits_from_hidden = kept_logits
        try:
            counted(spec_tick, windows)
        finally:
            be.logits_from_hidden = logits_from_hidden
        walls.append(time.perf_counter() - t0 - (spent["check"] - check0))
        slots.append(len(seated))
        for b, r, n0 in seated if log else ():
            rows[id(r)].extend(window["logits"][b, : len(r.tokens) - n0])

    def checked_forward(seg, pos, w):
        due = check(eng, seg, pos) if check else None
        if due:
            timed("check", due[0])
        window["after"] = due and due[1]
        return spec_forward(seg, pos, w)

    def kept_logits(params, hidden, backend="torch", mesh=None):
        out = logits_from_hidden(params, hidden, backend, mesh)
        window["logits"] = out.detach().float()
        if window.get("after"):
            timed("check", window.pop("after"), window["logits"])
        return out

    def timed_start(slot, req):
        t0 = time.perf_counter()
        start(slot, req)
        spent["admit"] += time.perf_counter() - t0

    def logged_sample(logits, sampled, draws):
        for b, r in enumerate(eng.slots):
            if r is not None:
                rows[id(r)].append(logits[b].detach().float().clone())
        return sample(logits, sampled, draws)

    def logged_first(logits, req, pos):
        rows[id(req)] = [logits.detach().float().clone()]
        return sample_first(logits, req, pos)

    eng._dispatch_tick = lambda active: counted(dispatch, ticks, active)
    eng._spec_tick, eng._spec_forward, eng._start_request = counted_spec_tick, checked_forward, timed_start
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
        for name in ("_dispatch_tick", "_spec_tick", "_spec_forward", "_start_request", "_sample",
                     "_sample_first"):
            eng.__dict__.pop(name, None)
    wall = time.perf_counter() - t0 - spent["check"]
    for r in results:
        if isinstance(r, Exception):
            raise AssertionError(f"a served request failed: {r!r}")
    return {
        "launches": {k: w.launches for k, w in wrappers.items()}, "ticks": ticks, "windows": windows,
        "walls": walls, "slots": slots, "wall_s": wall, "admit_s": spent["admit"], "check_s": spent["check"],
        "peak": torch.cuda.max_memory_allocated(), "tokens": [r.tokens for r in results], "results": results,
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


def phase_serve(kv_quant: bool, n_layers: int = 32) -> dict:
    """Slice 5's main path: ``PagedBatchEngine`` at full Llama-2-7B width,
    ``n_layers`` layers (4 over either pool since slice 19, 8 before: room in
    the script's time), INT8 weights, bf16 activations, backend ``cuda``, 8 slots,
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

    config = config_7b(n_layers)
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
    mark = stopwatch(f"phase_serve/{dn}")
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
    mark("warm_and_timed")

    logged = served_run(engine(pipeline_depth=1), reqs, log=True)
    torch.cuda.empty_cache()
    again = served_run(engine(), reqs)
    torch.cuda.empty_cache()
    if not logged["tokens"] == timed["tokens"] == again["tokens"]:
        raise AssertionError(f"{dn}: a rerun, or pipeline depth 1, gave other tokens")
    say("serve", path=dn, rerun="tokens_equal", pipeline_depth_1_vs_2="tokens_equal")
    mark("logged_and_rerun")
    check_served_tokens(params, config, reqs, logged, kv_quant, torch.bfloat16, dn, "margin")
    logged = again = None
    mark("plain_replays")

    tick_profiles(config, params, kw, dn)
    mark("tick_profiles")

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
    mark("dense_engine")
    dense = None
    params = None
    torch.cuda.empty_cache()
    return {**timed["launches"], **{f"dense-{k}": v for k, v in run["launches"].items()}}


SPEC_WINDOW = 4  # the served speculative windows' tokens (the server's --spec 4)
SPEC_CHECK_EVERY = 32  # the 16-layer leg holds one window in 32 to its plain forwards, the 8-layer legs all
SPEC_PROFILED = 3  # windows (and plain ticks) a leg profiles: tracing a window costs seconds
# launches per speculative window (ticks_per_sync 1: a tick is one window) at
# L layers, 8 slots x 4 tokens = 32 rows, by backend; a kernel not named
# launches 0 times. ``cuda``: the segment's five K6 a layer (the paged
# window's QKV with its rmsnorm prologue) and K5 for the 32 rows' logits,
# all on the fast M > 8 tile, attention in plain PyTorch; ``cuda-accurate``:
# the composed layer (wqkv, wo, w13, w2) on the accurate tile.
SPEC_WINDOWS = {
    "cuda": lambda L: {"K6": 5 * L, "K5": 1, "K6-tile": 5 * L, "K5-tile": 1},
    "cuda-accurate": lambda L: {"K6": 4 * L, "K5": 1, "K6-tile-acc": 4 * L, "K5-tile-acc": 1},
}


def hold_spec_streams(reqs, spec: dict, plain: dict, dn: str) -> dict:
    """Each speculative stream against the plain tick's stream of the same
    requests (PERF.md section 2's speculative rule): equal up to the first
    position whose plain top-2 margin is below twice the largest distance
    between a window's logits row and the plain tick's row at the same
    position (the rows of both runs up to and including the first token
    they disagree on share their prefix). A stream ended by BOS before its
    budget counts BOS as its last token. Returns what to report."""
    from llama2_tpu_torch.runtime.generator import BOS

    def stream(toks, prompt, gen):
        out = toks[len(prompt):]
        return out + [BOS] if len(toks) < gen.steps else out

    dist, split = 0.0, []
    for (prompt, gen), ts, tp, rs, lp in zip(reqs, spec["tokens"], plain["tokens"], spec["logits"],
                                            plain["logits"]):
        a, b = stream(ts, prompt, gen), stream(tp, prompt, gen)
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if k is None and len(a) != len(b):
            raise AssertionError(f"{dn}: a speculative stream and the plain one agree but end apart")
        n = min(len(a) if k is None else k + 1, len(rs), len(lp))
        dist = max(dist, float((rs[:n] - lp[:n]).abs().max()))
        split.append((k, lp))
    equal = 0
    for k, lp in split:
        if k is None:
            equal += 1
            continue
        top2 = lp[: k + 1].topk(2, dim=-1).values
        if not bool(((top2[:, 0] - top2[:, 1]) < 2 * dist).any()):
            raise AssertionError(f"{dn}: a speculative stream leaves the plain one at {k} with every margin "
                                 f"before it above twice the windows' distance {dist:.3e}")
    return {"streams_equal_to_plain": f"{equal}/{len(split)}",
            "first_split": ",".join(str(k) for k, _ in split if k is not None) or "none",
            "logit_max_abs_diff_window_vs_tick": f"{dist:.3e}"}


def window_checker(config, params, dtype, backend: str, every: int):
    """A ``served_run`` check holding every row of one window in ``every``
    (all d rows of each seated slot below seq_len, committed or not) to
    teacher-forced plain forwards of the same window on the same cache:
    ``backend="torch"`` in the engine's dtype and, for bf16, in float32
    activations on the same weights. The plain windows run first; they
    write the rows the engine's window then overwrites, and read only rows
    before them or their own. The rules are PERF.md section 2's: fp32 on
    ``cuda-accurate`` within F32_LOGIT_ATOL; fp32 on ``cuda`` (fast mode)
    within F32_FAST_LOGIT_RTOL of the largest logit; bf16 against the
    float32 logits, the window's max and mean distance at most the plain
    window's + BF16_MAX_MARGIN and x (1 + BF16_MEAN_MARGIN). Returns
    (check, verdict): ``verdict()`` raises past the rule, else returns what
    to report."""
    import torch

    from llama2_tpu_torch.models.llama import forward, logits_from_hidden
    from llama2_tpu_torch.models.paged import paged_forward_window
    from llama2_tpu_torch.quant.q8 import QuantTensor

    f32 = {k: v if isinstance(v, QuantTensor) else v.float() for k, v in params.items()} \
        if dtype == torch.bfloat16 else None
    st = {"windows": 0, "checked": 0, "rows": 0, "max": 0.0, "sum": 0.0, "max_plain": 0.0, "sum_plain": 0.0,
          "absmax": 0.0}

    def plain(eng, p, seg, pos):
        if hasattr(eng, "pool"):
            hidden = paged_forward_window(p, eng.pool.k, eng.pool.v, eng._upload(eng._tables), seg, pos, config,
                                          "torch", eng.pool.ks, eng.pool.vs)[0]
        else:
            hidden = forward(p, eng.cache, seg, pos, config, "torch")
        return logits_from_hidden(p, hidden, "torch").float()

    def check(eng, seg, pos):
        st["windows"] += 1
        if (st["windows"] - 1) % every:
            return None
        live = torch.tensor([r is not None for r in eng.slots], device=seg.device)
        keep = live[:, None] & (pos[:, None] + torch.arange(seg.shape[1], device=seg.device) < config.seq_len)
        out = {}

        def before():
            out["ref"] = plain(eng, f32, seg, pos)[keep] if f32 is not None else None
            out["want"] = plain(eng, params, seg, pos)[keep]

        def after(logits):
            ref, want = out["ref"], out["want"]
            got = logits[keep]
            st["checked"] += 1
            st["rows"] += got.shape[0]
            if ref is None:
                st["max"] = max(st["max"], float((got - want).abs().max()))
                st["absmax"] = max(st["absmax"], float(want.abs().max()))
                return
            dc, dt = (got - ref).abs(), (want - ref).abs()
            st["max"], st["max_plain"] = max(st["max"], float(dc.max())), max(st["max_plain"], float(dt.max()))
            st["sum"] += float(dc.mean(-1).sum())
            st["sum_plain"] += float(dt.mean(-1).sum())

        return before, after

    def verdict(dn: str) -> dict:
        out = {"windows_held_to_plain": f"{st['checked']}/{st['windows']}", "rows_held": st["rows"]}
        if st["checked"] == 0:
            raise AssertionError(f"{dn}: no window was held to its plain forward")
        if f32 is None:
            bound = F32_LOGIT_ATOL if backend == "cuda-accurate" else F32_FAST_LOGIT_RTOL * st["absmax"]
            out.update(window_logit_max_abs_diff_vs_plain=f"{st['max']:.3e}", bound=f"{bound:.3e}")
            if st["max"] > bound:
                raise AssertionError(f"{dn}: window logits {st['max']} from the plain window's, past {bound}")
            return out
        mean_c, mean_t = st["sum"] / st["rows"], st["sum_plain"] / st["rows"]
        out.update(vs_f32_activations_max_window=f"{st['max']:.4e}",
                   vs_f32_activations_max_plain=f"{st['max_plain']:.4e}", max_margin=BF16_MAX_MARGIN,
                   vs_f32_activations_mean_window=f"{mean_c:.4e}", vs_f32_activations_mean_plain=f"{mean_t:.4e}",
                   mean_margin=BF16_MEAN_MARGIN)
        if st["max"] > st["max_plain"] + BF16_MAX_MARGIN or mean_c > mean_t * (1 + BF16_MEAN_MARGIN):
            raise AssertionError(f"{dn}: the windows are {st['max']} (max) / {mean_c} (mean) from the fp32-"
                                 f"activation logits, the plain windows {st['max_plain']} / {mean_t}")
        return out

    return check, verdict


def phase_serve_spec() -> None:
    """Engine-level speculation on the served path: Llama-2-7B widths, INT8
    weights, bf16, ``cuda``, 8 slots, ``spec_window=4``,
    ``ticks_per_sync=1``, serving the greedy requests of serve_workload()
    through ``PagedBatchEngine`` over a bf16 pool (256-row pages, the
    prefix cache; 16 layers) and through the dense ``BatchEngine`` over the
    int8 cache (8 layers); then the paged engine in fp32 at 4 layers on ``cuda`` (fast
    mode: the bf16 legs' kernels) and on ``cuda-accurate``. Per leg: a
    logged speculative run with every window's launches asserted
    (SPEC_WINDOWS: no decode attention kernel and no megakernel in a window)
    and every row of its windows (one in SPEC_CHECK_EVERY on the 16-layer
    leg) held to plain forwards of the same window (``window_checker``);
    a logged run of the same engine without speculation (pipeline depth
    1), the streams held to each other by ``hold_spec_streams`` (on
    ``cuda-accurate`` the windows' logits within twice F32_LOGIT_ATOL of the
    ticks'). On the bf16 legs, printed beside the plain run's: served and
    decode tok/s, tokens a window and a slot-window, wall ms a window, and
    the wall and device ms of SPEC_PROFILED windows (and, for the dense
    engine, of as many plain ticks; the paged one's are phase_serve's) of 8
    slots seated on 16-token prompts (profiled)."""
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io.convert import random_q8_params
    from llama2_tpu_torch.runtime.batch_engine import BatchEngine
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

    t0 = time.perf_counter()
    reqs = [r for i, r in enumerate(serve_workload()) if i not in SAMPLED]
    # the dense int8-cache leg at 8 layers: room for slice 16's phases in the script's time; the fp32 legs
    # at 4 since slice 19 (8 before): room for its phase
    legs = (("paged", 16, torch.bfloat16, "cuda"), ("dense", 8, torch.bfloat16, "cuda"),
            ("paged", 4, torch.float32, "cuda"), ("paged", 4, torch.float32, "cuda-accurate"))
    params, built = None, None
    for kind, L, dtype, backend in legs:
        t_leg = time.perf_counter()
        config = config_7b(L)
        if built != (L, dtype, backend):  # the two bf16 legs share their fused weights
            params = None
            torch.cuda.empty_cache()
            params, built = random_q8_params(config, SEED, "cuda", dtype, group_size=GROUP), (L, dtype, backend)
        kw = dict(batch_size=SERVE_SLOTS, dtype=dtype, backend=backend, device="cuda", ticks_per_sync=1)

        def engine(**extra):
            if kind == "dense":
                return BatchEngine(config, params, kv_quant=True, **kw, **extra)
            return PagedBatchEngine(config, params, page_size=SERVE_PAGE, prefix_cache=True, **kw, **extra)

        pool = "int8-cache" if kind == "dense" else f"{dtype_name(dtype)}-pool"
        dn = f"q8/{dtype_name(dtype)}/{backend}/{kind}-{pool}/{L}L/spec{SPEC_WINDOW}"
        mark = stopwatch(f"phase_serve_spec/{dn}")
        eng = engine(spec_window=SPEC_WINDOW)
        params = eng.params  # fused once; the later engines take the same tensors
        check, verdict = window_checker(config, params, dtype, backend, SPEC_CHECK_EVERY if L >= 16 else 1)
        spec = served_run(eng, reqs, log=True, check=check)
        mark("params_and_spec_run")
        emitted = eng.metrics["tokens"]
        eng = None
        torch.cuda.empty_cache()
        per_window = SPEC_WINDOWS[backend](L)
        want = {k: per_window.get(k, 0) for k in spec["launches"]}
        bad = [w for w in spec["windows"] if w != want]
        if not spec["windows"] or bad or spec["ticks"]:
            raise AssertionError(f"{dn}: launches per window {bad[:1]}, want {want}; "
                                 f"{len(spec['ticks'])} plain ticks")
        held_windows = verdict(dn)
        eng = engine(pipeline_depth=1)
        plain = served_run(eng, reqs, log=True)
        plain_emitted = eng.metrics["tokens"]
        eng = None
        torch.cuda.empty_cache()
        mark("plain_run")
        held = hold_spec_streams(reqs, spec, plain, dn)
        if backend == "cuda-accurate" and float(held["logit_max_abs_diff_window_vs_tick"]) > 2 * F32_LOGIT_ATOL:
            raise AssertionError(f"{dn}: windows {held['logit_max_abs_diff_window_vs_tick']} from the ticks, "
                                 f"past twice F32_LOGIT_ATOL")
        say("serve-spec", path=dn, requests=len(reqs), windows=len(spec["windows"]),
            per_window=",".join(f"{k}={v}" for k, v in per_window.items()), **held_windows, **held)
        if dtype == torch.float32:
            say("serve-spec", path=dn, leg_seconds=f"{time.perf_counter() - t_leg:.1f}")
            continue
        n_win = len(spec["windows"])
        for name, run, n_steps, n_emit in (("spec", spec, n_win, emitted),
                                          ("plain_tick_depth_1", plain, len(plain["ticks"]), plain_emitted)):
            n_tok = sum(len(t) - len(p) for t, (p, _) in zip(run["tokens"], reqs))
            decode_s = run["wall_s"] - run["admit_s"]
            say("serve-spec", path=dn, run=name, generated=n_tok, wall_s=f"{run['wall_s']:.3f}",
                served_tok_s=f"{n_tok / run['wall_s']:.2f}", decode_tok_s=f"{n_emit / decode_s:.2f}",
                admission_s=f"{run['admit_s']:.3f}", windows_or_ticks=n_steps,
                tokens_per_window_or_tick=f"{n_emit / n_steps:.3f}",
                wall_ms_per_window_or_tick=f"{decode_s * 1e3 / n_steps:.3f}",
                checks_left_out_s=f"{run['check_s']:.3f}", peak_mem_GiB=f"{run['peak'] / 2**30:.2f}")
        say("serve-spec", path=dn, tokens_per_slot_window=f"{emitted / sum(spec['slots']):.3f}",
            window_wall_ms_in_spec_tick=f"{sum(spec['walls']) * 1e3 / n_win:.3f}")
        spec = plain = None
        # the paged engine's plain tick at these positions: phase_serve's tick_profiles
        for window in (SPEC_WINDOW, 0) if kind == "dense" else (SPEC_WINDOW,):
            eng = engine(spec_window=window)
            for p, _ in reqs[:SERVE_SLOTS]:
                eng.submit(p[:16], GenerationConfig(temperature=0.0, steps=16 + 40))
            eng._admit()
            profile_ticks(eng, dn if window else dn.replace(f"/spec{SPEC_WINDOW}", "/plain"),
                          f"pos_17_on_{SPEC_PROFILED}_windows" if window else f"pos_17_on_{SPEC_PROFILED}_ticks",
                          n=SPEC_PROFILED)
            eng._fail_all(RuntimeError("profile done"))
            eng = None
            torch.cuda.empty_cache()
            mark(f"profile_{'spec' if window else 'plain'}")
        say("serve-spec", path=dn, leg_seconds=f"{time.perf_counter() - t_leg:.1f}")
    params = None
    torch.cuda.empty_cache()
    say("serve-spec", seconds=f"{time.perf_counter() - t0:.1f}")


def phase_serve_accurate(kv_quant: bool) -> dict:
    """``cuda-accurate`` in fp32 at 4 layers (8 before slice 19: room in the
    script's time), the paged engine over an fp32 or
    an int8 pool (the composed layer: K6 four a layer, K15 or K16 one a
    layer, K5): launches per tick asserted, and the greedy streams of a
    logged run held to the plain path by the fp32 rules of PERF.md section 2
    (fp pool: every token, logits within F32_LOGIT_ATOL; int8 pool: within
    F32_FAST_LOGIT_RTOL of the largest logit, tokens where the margin is
    clear). Returns the launches."""
    import torch

    from llama2_tpu_torch.io.convert import random_q8_params
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

    config = config_7b(4)
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


def generate_bytes(path: str, spec: int, counts: dict | None = None) -> bytes:
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
    if counts is not None:  # the run's launches, by kernel
        counts.update({k: w.launches for k, w in wrappers.items()})
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


SERVER_ARGS = ("--quant", "int8", "--paged", "--kernels", "cuda", "--dtype", "f32", "--port", "0")


def run_server(path: str, extra: tuple, bodies: list, args: tuple = SERVER_ARGS, cwd: str = REPO,
               on_ready=None) -> dict:
    """``python -m llama2_tpu_torch.runtime.server <path> args extra`` as a
    subprocess from ``cwd`` (the package it imports): once it serves, call
    ``on_ready()``, POST ``bodies`` to /generate, all at once, read /health
    and /metrics, stop it with SIGINT. Returns the answers by index, the two
    reads, its start-up seconds and lines, and its exit code; the process is
    gone on return."""
    import signal
    import threading
    import urllib.request

    cmd = [sys.executable, "-m", "llama2_tpu_torch.runtime.server", path, "-z", TOKENIZER_BIN, *args, *extra]
    t0 = time.perf_counter()
    # a session of its own: the server and the ranks it spawns are killed together if it hangs
    proc = subprocess.Popen(cmd, cwd=cwd, stderr=subprocess.PIPE, text=True, start_new_session=True)

    def kill_all():
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    killer = threading.Timer(600, kill_all)  # a server that never comes up is killed
    killer.start()
    lines = []
    try:
        for line in proc.stderr:
            lines.append(line)
            if "serving on http://" in line:
                break
        url = next((w for w in lines[-1].split() if w.startswith("http://")), None) if lines else None
        if url is None:
            raise AssertionError("the server printed no address:\n" + "".join(lines))
        # keep reading: a full pipe would stall the server
        threading.Thread(target=lambda: lines.extend(proc.stderr), daemon=True).start()
        up_s = time.perf_counter() - t0
        if on_ready is not None:
            on_ready()

        def post(body):
            req = urllib.request.Request(url + "/generate", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                return json.loads(r.read())

        results = {}
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
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            killer.cancel()
            kill_all()
            proc.wait(timeout=30)
    if rc != 0:
        raise AssertionError(f"the server exited {rc} on SIGINT; its last lines:\n" + "".join(lines[-40:]))
    return {"results": results, "health": health, "metrics": metrics, "up_s": up_s, "rc": rc, "lines": lines}


def hold_server_spec_streams(path: str, results: dict) -> dict:
    """The greedy answers of the server run with ``--spec SPEC_WINDOW``,
    sent all at once: their tokens equal, token for token, those of an
    in-process paged engine with the server's settings and
    ``spec_window=SPEC_WINDOW`` given the same prompts at once. The server
    admits them as they arrive, the engine together: a window's rows do not
    depend on the rows batched with them (the window attends over the
    whole table), so the streams do not either. Returns what to report."""
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io import load_any
    from llama2_tpu_torch.quant.q8 import quantize_params
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine
    from llama2_tpu_torch.tokenizer.tokenizer import Tokenizer

    config, params, _ = load_any(path)
    params = quantize_params(params)
    tok = Tokenizer.from_file(TOKENIZER_BIN, config.vocab_size)
    eng = PagedBatchEngine(config, params, backend="cuda", device="cuda", batch_size=8, page_size=256,
                           n_pages=None, prefix_cache=False, dtype=torch.float32, kv_quant=False,
                           ticks_per_sync=1, pipeline_depth=2, spec_window=SPEC_WINDOW)
    queues = [eng.submit(tok.encode(prompt), GenerationConfig(temperature=0.0, steps=48))
              for prompt in SERVER_PROMPTS]
    eng.run_until_idle()
    want = [q.get(timeout=600).tokens for q in queues]
    windows = eng.metrics["spec_windows"]
    del eng
    for i, (prompt, w) in enumerate(zip(SERVER_PROMPTS, want)):
        if results[i]["tokens"] != w:
            raise AssertionError(f"--spec {SPEC_WINDOW}: served tokens for {prompt!r} differ from the "
                                 "in-process speculative engine's")
    if windows < 1:
        raise AssertionError("the in-process speculative engine ran no window")
    return {"tokens_equal_to_in_process_spec_engine": "all", "in_process_windows": windows}


def phase_server(path: str) -> None:
    """The HTTP server on the 2-layer checkpoint at ``path``, as a user
    starts it: ``python -m llama2_tpu_torch.runtime.server <path> --quant int8
    --paged --kernels cuda --dtype f32 --port 0``. Three concurrent greedy
    requests must return the tokens of an in-process paged engine with the
    server's settings, and are held to ``Generator.generate`` on the same
    prompts by the margin rule (fp32 activations, 2 layers;
    ``hold_server_streams``), one sampled request
    returns its budget; /health and /metrics answer; SIGINT stops it with
    exit 0. Then the same server with ``--spec 4``: three concurrent greedy
    requests must return the tokens of an in-process speculative engine with
    its settings (``hold_server_spec_streams``)."""
    bodies = [{"prompt": p, "temperature": 0.0, "steps": 48} for p in SERVER_PROMPTS]
    bodies.append({"prompt": SERVER_PROMPTS[0], "temperature": 0.8, "top_p": 0.9, "steps": 48, "seed": 7})
    run = run_server(path, (), bodies)
    results, health, metrics, rc = run["results"], run["health"], run["metrics"], run["rc"]
    held = hold_server_streams(path, results)
    sampled = results[len(SERVER_PROMPTS)]["tokens"]
    if not 1 <= len(sampled) <= 48 or health.get("status") != "ok" or metrics.get("requests", 0) < len(bodies):
        raise AssertionError(f"server answers malformed: {sampled}, {health}, {metrics}")
    say("server", args="--quant_int8_--paged_--kernels_cuda_--dtype_f32", up_s=f"{run['up_s']:.1f}",
        greedy_requests=len(SERVER_PROMPTS), **held, sampled_tokens=len(sampled),
        health=health["status"], metrics_requests=metrics["requests"],
        ttft_p50_ms=f"{metrics['ttft_p50_ms']:.2f}", sigint_exit=rc)
    spec = run_server(path, ("--spec", str(SPEC_WINDOW)), bodies[: len(SERVER_PROMPTS)])
    held = hold_server_spec_streams(path, spec["results"])
    if spec["health"].get("status") != "ok" or spec["metrics"].get("requests", 0) < len(SERVER_PROMPTS):
        raise AssertionError(f"--spec server answers malformed: {spec['health']}, {spec['metrics']}")
    say("server", args=f"--quant_int8_--paged_--kernels_cuda_--dtype_f32_--spec_{SPEC_WINDOW}",
        up_s=f"{spec['up_s']:.1f}", greedy_requests=len(SERVER_PROMPTS), sent="at_once", **held,
        sigint_exit=spec["rc"])


def phase_cli() -> None:
    """The CLI on a v0 fp32 checkpoint at 7B width with 2 layers; the same
    file quantized on load (``--quant int8``); the ak42 INT8 file that
    ``python -m llama2_tpu_torch.quant.convert`` writes from it; the
    param-cache directory that ``--save-cache`` writes from that, which must
    print the same bytes; the INT8 file with ``--kv-cache int8 --spec 4``,
    which must print ``Generator.generate``'s bytes (without ``--spec``:
    ``phase_tools``, on the imported INT8 cache); then ``phase_server``."""
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
        # (without --spec: phase_tools holds it on the imported INT8 cache)
        extra = ("--kv-cache", "int8", "--spec", "4")
        out_kv, _ = run_cli(q8_path, "--kernels", "cuda", "--dtype", "bf16", *extra)
        if out_kv != generate_bytes(q8_path, 4):
            raise AssertionError(f"the CLI with {' '.join(extra)} prints other bytes than Generator.generate")
        t_server = time.perf_counter()
        phase_server(path)
        say("phase", name="phase_cli/phase_server", seconds=f"{time.perf_counter() - t_server:.1f}")
    finally:
        for f in (path, q8_path):
            if os.path.exists(f):
                os.remove(f)
        shutil.rmtree(cache_dir, ignore_errors=True)


# ---------------------------------------------------------------- phase 4b


PPL_TOKENS = 512  # the perplexity corpus: seeded token ids
PPL_CHUNK = 256
# per-token NLL limits: a log-softmax moves by at most twice the largest
# logit change, so section 2's logit limits, doubled
PPL_F32_ATOL = 2 * F32_LOGIT_ATOL
PPL_BF16_MAX_MARGIN = 2 * BF16_MAX_MARGIN
PPL_GATE = 5e-3  # |dNLL| of Q8 weights from the fp32 weights they came from: the JAX package's gate, at its fixture
# launches per 256-token chunk at L layers (K5: the classifier over every position, M = 256)
PPL_CHUNKS = {
    "cuda": lambda L: {"K1": L, "K1-mma": L, "K6": 5 * L, "K6-tile": 5 * L, "K5": 1, "K5-tile": 1},
    "cuda-accurate": lambda L: {"K1": L, "K1-tf32": L, "K6": 4 * L, "K6-tile-acc": 4 * L, "K5": 1,
                                "K5-tile-acc": 1},
}


def gate_fixture_params(config, seed: int = 5, scale: float = 0.02) -> dict:
    """The JAX package's INT8 gate fixture (``tests/test_perplexity.py::
    test_int8_ppl_gate_1b_shape``): the numpy weights of its
    ``tests/conftest.py::random_params`` draw for draw, the classifier a copy
    of the embedding's transpose."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * scale

    L, D, HD, V, KV = config.n_layers, config.dim, config.hidden_dim, config.vocab_size, config.kv_dim
    tok_emb = r(V, D)
    return {"tok_emb": tok_emb, "rms_att": 1.0 + r(L, D), "wq": r(L, D, D), "wk": r(L, D, KV),
            "wv": r(L, D, KV), "wo": r(L, D, D), "rms_ffn": 1.0 + r(L, D), "w1": r(L, D, HD),
            "w2": r(L, HD, D), "w3": r(L, D, HD), "rms_final": 1.0 + r(D), "wcls": tok_emb.T.copy()}


def ppl_corpus(vocab: int) -> list[int]:
    import numpy as np

    return [int(t) for t in np.random.default_rng(SEED).integers(3, vocab, PPL_TOKENS)]


def ppl_run(config, params, corpus, backend: str, dn: str, counted: bool = False):
    """``tools/perplexity.py::token_nlls`` of the corpus, chunk PPL_CHUNK, on
    the card. ``counted``: every launch counted from 0 and held to
    PPL_CHUNKS a chunk, then a second run timed and held bit-equal to the
    first. Returns (per-token NLLs, seconds of the timed run or None,
    launches)."""
    import numpy as np
    import torch

    from llama2_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_stacked
    from llama2_tpu_torch.tools.perplexity import token_nlls

    if not counted:
        return token_nlls(config, params, corpus, PPL_CHUNK, backend), None, {}
    wrappers = {**count_launches(), "K6-tile": VariantCount(quant_matmul_stacked, "launches_tile_fast"),
                "K5-tile": VariantCount(quant_matmul, "launches_tile_fast"),
                "K5-tile-acc": VariantCount(quant_matmul, "launches_tile_accurate")}
    for w in wrappers.values():
        w.launches = 0
    nll = token_nlls(config, params, corpus, PPL_CHUNK, backend)
    launches = {k: w.launches for k, w in wrappers.items()}
    chunks = -(-min(len(corpus), config.seq_len - 1) // PPL_CHUNK)
    per_chunk = PPL_CHUNKS[backend](config.n_layers)
    want = {k: chunks * per_chunk.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"{dn}: perplexity launches {launches}, want {want}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = token_nlls(config, params, corpus, PPL_CHUNK, backend)
    secs = time.perf_counter() - t0
    if not np.array_equal(again, nll):
        raise AssertionError(f"{dn}: a second perplexity run gives other NLLs")
    say("ppl", path=dn, chunks=chunks, per_chunk=",".join(f"{k}={v}" for k, v in per_chunk.items()),
        scored_tokens=len(nll), nll=f"{float(nll.mean()):.6f}", seconds=f"{secs:.3f}",
        scored_tok_s=f"{len(nll) / secs:.1f}", ms_per_chunk=f"{secs * 1e3 / chunks:.2f}")
    return nll, secs, launches


def phase_perplexity() -> dict:
    """``tools/perplexity.py`` at Llama-2-7B width and 32 layers on a
    512-token seeded corpus, chunk 256 (the classifier K5 over all 256
    positions of a chunk, on its M > 8 tile), on the main path's seeded
    random Q8 weights: (a) ``cuda-accurate`` on fp32 activations against the
    plain path (``backend="torch"``), every token's NLL within PPL_F32_ATOL;
    (b) ``cuda`` on bf16 activations against the fp32 plain path's NLLs,
    max distance at most the plain bf16 path's + PPL_BF16_MAX_MARGIN and
    mean at most (1 + BF16_MEAN_MARGIN) times its; (c) the quality gate:
    fp32 weights (cuBLAS projections, ``cuda-accurate``) against their own
    quantization (on the card) on ``cuda-accurate``, the mean NLL's change
    equal to the plain path's within 2 * PPL_F32_ATOL (the kernels add
    nothing to the quantizer's loss), at the JAX gate's own fixture
    (``gate_fixture_params``: TinyLlama-1.1B's shape, its seeds, 192 tokens,
    chunk 64), where it must stay under the JAX package's PPL_GATE, and at
    7B and 32 layers (seeded weights, the 512-token corpus), where random
    weights move it past that gate: reported. Launches a chunk asserted
    (PPL_CHUNKS). Returns the K5 launches of (a) and (b)."""
    import math

    import numpy as np
    import torch

    from llama2_tpu_torch.config import ModelConfig
    from llama2_tpu_torch.io.convert import random_params, random_q8_params
    from llama2_tpu_torch.quant.q8 import quantize_params
    from llama2_tpu_torch.runtime.generator import prepare_params
    from llama2_tpu_torch.tools.perplexity import token_nlls

    t0 = time.perf_counter()
    config = config_7b(32)
    corpus = ppl_corpus(config.vocab_size)
    dev = torch.device("cuda")
    base = random_q8_params(config, SEED, dev, torch.float32, group_size=GROUP)
    out = {}
    ref, _, _ = ppl_run(config, prepare_params(base, torch.float32, "torch", dev), corpus, "torch", "")
    p = prepare_params(base, torch.float32, "cuda-accurate", dev)
    a, _, out["accurate"] = ppl_run(config, p, corpus, "cuda-accurate", "q8/f32/cuda-accurate/32L", True)
    p = None
    err_a = float(np.abs(a - ref).max())
    say("ppl", rule="a", path="q8/f32/cuda-accurate/32L", nll_max_abs_diff_vs_plain=f"{err_a:.3e}",
        bound=PPL_F32_ATOL, plain_nll=f"{float(ref.mean()):.6f}")
    if err_a > PPL_F32_ATOL:
        raise AssertionError(f"(a) per-token NLL {err_a} from the plain path's, past {PPL_F32_ATOL}")
    plain16, _, _ = ppl_run(config, prepare_params(base, torch.bfloat16, "torch", dev), corpus, "torch", "")
    p = prepare_params(base, torch.bfloat16, "cuda", dev)
    b, _, out["fast"] = ppl_run(config, p, corpus, "cuda", "q8/bf16/cuda/32L", True)
    p = base = None
    torch.cuda.empty_cache()
    db, dp = np.abs(b - ref), np.abs(plain16 - ref)
    say("ppl", rule="b", path="q8/bf16/cuda/32L", vs_f32_max_kernel=f"{db.max():.4e}",
        vs_f32_max_plain=f"{dp.max():.4e}", max_margin=PPL_BF16_MAX_MARGIN,
        vs_f32_mean_kernel=f"{db.mean():.4e}", vs_f32_mean_plain=f"{dp.mean():.4e}", mean_margin=BF16_MEAN_MARGIN)
    if db.max() > dp.max() + PPL_BF16_MAX_MARGIN or db.mean() > dp.mean() * (1 + BF16_MEAN_MARGIN):
        raise AssertionError(f"(b) bf16 NLLs {db.max()} / {db.mean()} from fp32's, the plain bf16 path's "
                             f"{dp.max()} / {dp.mean()}")
    # (c): fp32 weights and their quantization, both on the card, at the JAX
    # gate's own fixture and at 7B
    gate_config = ModelConfig(dim=2048, hidden_dim=5632, n_layers=22, n_heads=32, n_kv_heads=4,
                              vocab_size=32000, seq_len=256)
    fixtures = (
        ("jax-gate-fixture-1.1b/22L", gate_config, lambda: gate_fixture_params(gate_config),
         [int(t) for t in np.random.default_rng(7).integers(3, gate_config.vocab_size, 192)], 64),
        ("7b/32L", config, lambda: random_params(config, SEED, dev, torch.float32), corpus, PPL_CHUNK),
    )
    for name, cfg, make, toks, chunk in fixtures:
        fp = make()
        nll = {}
        for backend in ("cuda-accurate", "torch"):
            nll["fp32", backend] = float(token_nlls(cfg, prepare_params(fp, torch.float32, backend, dev), toks,
                                                    chunk, backend).mean())
        q8 = quantize_params(prepare_params(fp, torch.float32, "torch", dev))
        fp = None
        torch.cuda.empty_cache()
        for backend in ("cuda-accurate", "torch"):
            nll["q8", backend] = float(token_nlls(cfg, prepare_params(q8, torch.float32, backend, dev), toks,
                                                  chunk, backend).mean())
        q8 = None
        torch.cuda.empty_cache()
        delta = nll["q8", "cuda-accurate"] - nll["fp32", "cuda-accurate"]
        delta_plain = nll["q8", "torch"] - nll["fp32", "torch"]
        say("ppl", rule="c", fixture=name, tokens=len(toks), chunk=chunk,
            fp32_nll=f"{nll['fp32', 'cuda-accurate']:.6f}", q8_nll=f"{nll['q8', 'cuda-accurate']:.6f}",
            fp32_ppl=f"{math.exp(nll['fp32', 'cuda-accurate']):.2f}", q8_ppl=f"{math.exp(nll['q8', 'cuda-accurate']):.2f}",
            delta_nll=f"{delta:.4e}", delta_nll_plain_path=f"{delta_plain:.4e}",
            gate=PPL_GATE if cfg is gate_config else "none", peak_mem_GiB=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
        # the kernels add nothing to the quantizer's loss: each mean within (a)'s per-token bound
        if abs(delta - delta_plain) > 2 * PPL_F32_ATOL:
            raise AssertionError(f"(c) {name}: the kernels' Q8 delta {delta} is not the plain path's {delta_plain}")
        if cfg is gate_config and not abs(delta) < PPL_GATE:
            raise AssertionError(f"(c) {name}: Q8 NLL {delta} from the fp32 weights', past the gate {PPL_GATE}")
    say("ppl", seconds=f"{time.perf_counter() - t0:.1f}")
    return out


HF_DTYPE = "BF16"


def write_safetensors(path: str, tensors: dict) -> None:
    """``tensors`` (name: uint16 numpy array of bf16 bits) as one
    ``.safetensors`` file, written here without the ``safetensors``
    package: an 8-byte little-endian header length, the JSON header, the
    data."""
    import struct

    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, a in tensors.items():
        header[name] = {"dtype": HF_DTYPE, "shape": list(a.shape), "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)))
        f.write(h)
        for a in tensors.values():
            a.tofile(f)


def write_hf_dir(d: str, config) -> dict:
    """A Hugging Face Llama directory at ``config``'s widths and depth:
    ``config.json`` and seeded bf16 weights (HF's names and (out, in)
    layout, an untied ``lm_head``) in two safetensors shards. Returns every
    tensor's bf16 bits (uint16 numpy arrays) by HF name."""
    import torch

    L, D, HD, V = config.n_layers, config.dim, config.hidden_dim, config.vocab_size
    H, KVH, hs = config.n_heads, config.n_kv_heads, config.head_size
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def bits(*shape, loc=0.0):
        t = torch.randn(shape, generator=gen, device="cuda").mul_(0.02).add_(loc).to(torch.bfloat16)
        return t.view(torch.int16).cpu().numpy().view("<u2")

    shards = [{"model.embed_tokens.weight": bits(V, D)}, {}]
    for i in range(L):
        p = f"model.layers.{i}."
        shards[min(i, 1)].update({
            p + "input_layernorm.weight": bits(D, loc=1.0),
            p + "self_attn.q_proj.weight": bits(H * hs, D), p + "self_attn.k_proj.weight": bits(KVH * hs, D),
            p + "self_attn.v_proj.weight": bits(KVH * hs, D), p + "self_attn.o_proj.weight": bits(D, H * hs),
            p + "post_attention_layernorm.weight": bits(D, loc=1.0),
            p + "mlp.gate_proj.weight": bits(HD, D), p + "mlp.up_proj.weight": bits(HD, D),
            p + "mlp.down_proj.weight": bits(D, HD),
        })
    shards[1].update({"model.norm.weight": bits(D, loc=1.0), "lm_head.weight": bits(V, D)})
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "architectures": ["LlamaForCausalLM"], "hidden_size": D,
                   "intermediate_size": HD, "num_hidden_layers": L, "num_attention_heads": H,
                   "num_key_value_heads": KVH, "vocab_size": V, "max_position_embeddings": config.seq_len,
                   "rms_norm_eps": config.norm_eps, "tie_word_embeddings": False, "torch_dtype": "bfloat16"}, f)
    for k, shard in enumerate(shards):
        write_safetensors(os.path.join(d, f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"), shard)
    return {k: v for shard in shards for k, v in shard.items()}


def hf_params(hf: dict, config) -> dict:
    """The engine's params re-derived in numpy from HF bf16 bits: widened to
    float32 (the upper half of a float32), wq/wk un-permuted from HF's
    rotate_half row order (a head's (hs/2, 2) rows back to (2, hs/2)), every
    matrix transposed to (in, out), layers stacked."""
    import numpy as np

    def f32(name):
        return (hf[name].astype(np.uint32) << 16).view(np.float32)

    def unpermute(w, heads):
        return w.reshape(heads, 2, w.shape[0] // heads // 2, -1).transpose(0, 2, 1, 3).reshape(w.shape[0], -1)

    def stack(fn):
        return np.stack([fn(f"model.layers.{i}.") for i in range(config.n_layers)])

    return {
        "tok_emb": f32("model.embed_tokens.weight"),
        "rms_att": stack(lambda p: f32(p + "input_layernorm.weight")),
        "wq": stack(lambda p: unpermute(f32(p + "self_attn.q_proj.weight"), config.n_heads).T),
        "wk": stack(lambda p: unpermute(f32(p + "self_attn.k_proj.weight"), config.n_kv_heads).T),
        "wv": stack(lambda p: f32(p + "self_attn.v_proj.weight").T),
        "wo": stack(lambda p: f32(p + "self_attn.o_proj.weight").T),
        "rms_ffn": stack(lambda p: f32(p + "post_attention_layernorm.weight")),
        "w1": stack(lambda p: f32(p + "mlp.gate_proj.weight").T),
        "w2": stack(lambda p: f32(p + "mlp.down_proj.weight").T),
        "w3": stack(lambda p: f32(p + "mlp.up_proj.weight").T),
        "rms_final": f32("model.norm.weight"),
        "wcls": f32("lm_head.weight").T,
    }


KERNEL_EVENT = re.compile(r"(\w+)<([^<>]*)>\(")


def trace_counts(trace_dir: str, classifier_strips: int) -> dict:
    """Kernel events of the one Chrome trace in ``trace_dir``: K13's (the
    megakernel with its attention phase, ``mlp_block_kernel<MT, U, true,
    MMA>``) and K5's (the decode-row kernel over the classifier's column
    strips: ``gemv_kernel`` on a grid of ``classifier_strips`` blocks
    across; K6 shares the kernel on narrower grids), and all of them."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"--profile wrote {files} into {trace_dir}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    counts = {"K13": 0, "K5": 0, "kernels": len(events)}
    for e in events:
        m = KERNEL_EVENT.search(e.get("name", ""))
        if m is None:
            continue
        targs = [a.strip() for a in m.group(2).split(",")]
        if m.group(1) == "mlp_block_kernel" and targs[2] == "true":
            counts["K13"] += 1
        elif m.group(1) == "gemv_kernel" and e.get("args", {}).get("grid", [0])[0] == classifier_strips:
            counts["K5"] += 1
    return counts


def tokenizer_check() -> None:
    """``load_tokenizer`` builds and returns the C++ tokenizer; its ids equal
    the Python tokenizer's on the perplexity corpus's text and on seeded
    random text of the vocabulary's one-codepoint tokens; both encode rates."""
    import random

    from llama2_tpu_torch.tokenizer.fast import FastTokenizer, lib_path, load_tokenizer
    from llama2_tpu_torch.tokenizer.tokenizer import Tokenizer

    t0 = time.perf_counter()
    fast = load_tokenizer(TOKENIZER_BIN, 32000)
    load_s = time.perf_counter() - t0
    py = Tokenizer.from_file(TOKENIZER_BIN, 32000)
    if not isinstance(fast, FastTokenizer) or not os.path.exists(lib_path()):
        raise AssertionError(f"load_tokenizer gave {type(fast).__name__}")
    corpus = "".join(ch for ch in py.decode(ppl_corpus(32000)).decode("utf-8", "ignore")
                     if py.lookup(ch) is not None)
    singles = sorted({t.decode("utf-8", "ignore") for t in py.tokens
                      if len(t.decode("utf-8", "ignore")) == 1 and t.decode("utf-8", "ignore").encode() == t})
    rng = random.Random(SEED)
    unicode_text = "".join(rng.choice(singles) if rng.random() < 0.8 else " " for _ in range(2000))
    rates = {}
    for name, text in (("corpus", corpus), ("random_unicode", unicode_text)):
        times = {}
        for kind, tok in (("cpp", fast), ("python", py)):
            t1 = time.perf_counter()
            ids = tok.encode(text)
            times[kind] = (time.perf_counter() - t1, ids)
        if times["cpp"][1] != times["python"][1]:
            raise AssertionError(f"the C++ tokenizer's ids differ from the Python one's on the {name} text")
        n = len(times["cpp"][1])
        rates[name] = {k: n / max(t, 1e-9) for k, (t, _) in times.items()}
        say("tokenizer", text=name, chars=len(text), tokens=n, ids_equal="yes",
            cpp_tok_s=f"{rates[name]['cpp']:.0f}", python_tok_s=f"{rates[name]['python']:.0f}")
    say("tokenizer", load_tokenizer="FastTokenizer", first_load_s=f"{load_s:.2f}",
        library=os.path.relpath(lib_path(), REPO))


def precompile_in_process(path: str) -> None:
    """The server's engine (dense, 8 slots, bf16, ``cuda``, int8 KV cache) on
    the 2-layer INT8 cache at ``path``: ``precompile((16, 128), (False,
    True))`` on emptied plan caches, which must fill some, then a first wave
    (two 16- and two 128-token prompts, greedy and sampled) that must start
    no ``nvcc`` and miss no launch plan."""
    import numpy as np
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io import load_any
    from llama2_tpu_torch.ops.cuda import build
    from llama2_tpu_torch.runtime.batch_engine import PLAN_CACHES, BatchEngine

    config, params, _ = load_any(path)
    eng = BatchEngine(config, params, batch_size=8, dtype=torch.bfloat16, backend="cuda", device="cuda",
                      kv_quant=True)
    for f in PLAN_CACHES.values():  # the earlier phases filled plans of these shapes: start cold
        f.cache_clear()
    t0 = time.perf_counter()
    n = eng.precompile(prompt_lens=(16, 128), stochastic=(False, True))
    secs = time.perf_counter() - t0
    misses = {k: f.cache_info().misses for k, f in PLAN_CACHES.items()}
    started, start_build = [], build._start_build
    build._start_build = lambda *a: started.append(a[0]) or start_build(*a)
    try:
        rng = np.random.default_rng(SEED + 3)
        gens = (GenerationConfig(temperature=0.0, steps=48), GenerationConfig(temperature=0.8, steps=48, seed=5))
        queues = [eng.submit([int(t) for t in rng.integers(3, config.vocab_size, n_tok)], g)
                  for n_tok in (16, 128) for g in gens]
        eng.run_until_idle()
        tokens = [q.get(timeout=600).tokens for q in queues]
    finally:
        build._start_build = start_build
    missed = {k: f.cache_info().misses - misses[k] for k, f in PLAN_CACHES.items()}
    if n < 1 or started or any(missed.values()) or not all(tokens):
        raise AssertionError(f"after precompile the first wave built {started} and missed plans {missed}")
    say("precompile", where="in_process", programs=n, seconds=f"{secs:.2f}", first_wave_requests=len(queues),
        first_wave_nvcc=0, first_wave_plan_misses=0)


def phase_precompile(path: str) -> None:
    """Cold start: the server on the 2-layer INT8 cache at ``path`` (dense
    engine, ``--kernels cuda --dtype bf16 --kv-cache int8``) started with
    ``--precompile 16,128`` from a copy of the package whose ``build/`` is
    empty, so that it builds every kernel library and the tokenizer itself:
    its time to ready, its ``precompiled N programs`` line, and its first
    request's TTFT, with no library built after it was ready; then the same
    server without the flag from the repository (libraries built) and its
    first request's TTFT; then ``precompile_in_process``."""
    import shutil

    cold = os.path.join(REPO, "build", "cold")
    shutil.rmtree(cold, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "llama2_tpu_torch"), os.path.join(cold, "llama2_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    libs = os.path.join(cold, "build", "kernels")
    args = ("--kernels", "cuda", "--dtype", "bf16", "--kv-cache", "int8", "--port", "0")
    body = [{"prompt": CLI_PROMPT, "temperature": 0.0, "steps": 48}]
    ready = {}

    def listing():
        return sorted(os.listdir(libs)) if os.path.isdir(libs) else []

    try:
        run = run_server(path, ("--precompile", "16,128"), body, args=args, cwd=cold,
                         on_ready=lambda: ready.setdefault("libs", listing()))
        after = listing()
        line = next((x.strip() for x in run["lines"] if x.startswith("precompiled ")), None)
        m = re.match(r"precompiled (\d+) programs in ([\d.]+)s", line or "")
        want = {"attention_q8", "quant_matmul", "mlp_block"}
        built = {f.split("-")[0] for f in ready["libs"] if f.endswith(".so")}
        if m is None or int(m.group(1)) < len(want) or built != want or after != ready["libs"]:
            raise AssertionError(f"cold --precompile server: {line!r}, libraries at ready {ready['libs']}, "
                                 f"after its first request {after}")
        if not os.listdir(os.path.join(cold, "build", "tokenizer")):
            raise AssertionError("the cold server built no tokenizer library")
        cold_ttft = run["results"][0]["ttft_ms"]
        say("precompile", where="cold_server", args="--kernels_cuda_--dtype_bf16_--kv-cache_int8_--precompile_16,128",
            up_s=f"{run['up_s']:.1f}", programs=m.group(1), precompile_s=m.group(2),
            libraries_built=",".join(sorted(built)), libraries_built_after_ready=0,
            first_request_ttft_ms=f"{cold_ttft:.1f}", sigint_exit=run["rc"])
    finally:
        shutil.rmtree(cold, ignore_errors=True)
    warm = run_server(path, (), body, args=args)
    if warm["results"][0]["tokens"] != run["results"][0]["tokens"]:
        raise AssertionError("the --precompile server's answer differs from the server's without it")
    say("precompile", where="warm_server_no_flag", up_s=f"{warm['up_s']:.1f}",
        first_request_ttft_ms=f"{warm['results'][0]['ttft_ms']:.1f}", answers_equal="yes", sigint_exit=warm["rc"])
    precompile_in_process(path)


def phase_tools() -> dict:
    """This slice's path beside the perplexity gate (``phase_perplexity``):
    the HF importer, the CLI's ``--profile``, the C++ tokenizer and
    ``--precompile``. A Hugging Face directory at Llama-2-7B width and 2
    layers (bf16, two shards, untied ``lm_head``; ``write_hf_dir``) is
    imported by ``tools/import_hf.py`` to a v0 ``.bin`` and to an INT8 param
    cache (``--cache --int8``); the ``.bin`` loads the numpy re-derivation's
    params exactly (``hf_params``). The CLI (``--kernels cuda --dtype bf16
    --kv-cache int8``) prints the same bytes on the INT8 cache, on the
    ``.bin`` with ``--quant int8``, and on the cache with ``--profile DIR``,
    whose trace holds K13's and K5's kernel events at the launch counts of
    the same generate in this process. Then ``tokenizer_check`` and
    ``phase_precompile`` on the INT8 cache."""
    import shutil

    import numpy as np

    from llama2_tpu_torch.io import load_any
    from llama2_tpu_torch.tools import import_hf

    t0 = time.perf_counter()
    config = config_7b(n_layers=2)
    smoke = os.path.join(REPO, "build", "smoke")
    hf_dir, bin_path = os.path.join(smoke, "hf-llama-7b-width-2-layers"), os.path.join(smoke, "imported.bin")
    cache_dir, trace_dir = os.path.join(smoke, "imported-q8-cache"), os.path.join(smoke, "trace")
    mark = stopwatch("phase_tools")
    try:
        hf = write_hf_dir(hf_dir, config)
        mark("write_hf_dir")
        hf_bytes = sum(os.path.getsize(os.path.join(hf_dir, f)) for f in os.listdir(hf_dir))
        t1 = time.perf_counter()
        if import_hf.main([hf_dir, bin_path]) != 0 or import_hf.main([hf_dir, cache_dir, "--cache", "--int8"]) != 0:
            raise AssertionError("import_hf exited non-zero")
        import_s = time.perf_counter() - t1
        got_config, got, shared = load_any(bin_path)
        want = hf_params(hf, config)
        hf = None
        if got_config != config or shared or sorted(got) != sorted(want):
            raise AssertionError(f"imported {got_config}, shared={shared}, {sorted(got)}")
        for k in want:
            if not np.array_equal(got[k], want[k]):
                raise AssertionError(f"imported {k} differs from the numpy re-derivation")
        got = want = None
        mark("import_and_compare")
        say("import_hf", hf_dir_GB=f"{hf_bytes / 1e9:.2f}", shards=2, dtype="bf16", lm_head="untied",
            bin_GB=f"{os.path.getsize(bin_path) / 1e9:.2f}", seconds_bin_and_int8_cache=f"{import_s:.1f}",
            params_equal_to_numpy="exact")
        flags = ("--kernels", "cuda", "--dtype", "bf16", "--kv-cache", "int8")
        out_cache, _ = run_cli(cache_dir, *flags)
        out_bin, _ = run_cli(bin_path, "--quant", "int8", *flags)
        if out_bin != out_cache:
            raise AssertionError("the imported .bin with --quant int8 prints other bytes than the imported INT8 cache")
        shutil.rmtree(trace_dir, ignore_errors=True)
        out_prof, err = run_cli(cache_dir, *flags, "--profile", trace_dir)
        if out_prof != out_cache or "wrote profile trace to" not in err:
            raise AssertionError("--profile changed the CLI's bytes or wrote no trace")
        counts: dict = {}
        if generate_bytes(cache_dir, 0, counts) != out_cache:
            raise AssertionError("the CLI on the imported cache prints other bytes than Generator.generate")
        from llama2_tpu_torch.ops.cuda.quant_matmul import _STRIP

        traced = trace_counts(trace_dir, -(-config.vocab_size // _STRIP))
        if traced["K13"] != counts["K13"] or traced["K5"] != counts["K5"] or not counts["K13"]:
            raise AssertionError(f"the trace holds K13 {traced['K13']}, K5 {traced['K5']} kernel events; "
                                 f"the generate launched K13 {counts['K13']}, K5 {counts['K5']}")
        say("profile", args="--kernels_cuda_--dtype_bf16_--kv-cache_int8_--profile", stdout_equal="yes",
            trace_kernel_events=traced["kernels"], K13_events=traced["K13"], K13_launches=counts["K13"],
            K5_events=traced["K5"], K5_launches=counts["K5"])
        mark("cli_and_profile")
        tokenizer_check()
        phase_precompile(cache_dir)
        mark("tokenizer_and_precompile")
    finally:
        shutil.rmtree(hf_dir, ignore_errors=True)
        shutil.rmtree(cache_dir, ignore_errors=True)
        shutil.rmtree(trace_dir, ignore_errors=True)
        if os.path.exists(bin_path):
            os.remove(bin_path)
    say("tools", seconds=f"{time.perf_counter() - t0:.1f}")


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


def mesh_k10_timing(cycles_per_ms: float, gen) -> dict:
    """K10 as a rank of ``phase_mesh``'s 1x2 leg runs it in a decode tick: 8
    rows of bf16 activations, D 4096, HD/tp = 5504, ``residual=False``, call i
    on layer i % 32 of a random 32-layer Q8 stack, against its plain version
    at ``mlp_tolerance``, beside the composed route of that rank (w1 and w3
    separate, as ``fuse_layer_params`` keeps them under shards, then swiglu
    and w2, each output without the residual) and its bound (each weight
    byte and scale, the 8 input and 8 output rows once over the memory rate,
    or 2 * 8 operations a weight over the bf16 peak). No one PyTorch call
    computes it: ``library_ms`` null. Returns the kernel line's row without
    ``launches``."""
    import torch

    from llama2_tpu_torch.ops import ref
    from llama2_tpu_torch.ops.cuda import mlp_block as mb
    from llama2_tpu_torch.ops.cuda.quant_matmul import quant_matmul_stacked
    from llama2_tpu_torch.quant.q8 import QuantTensor

    L, M, D, HD, dtype, eps = 32, SERVE_SLOTS, 4096, 11008 // 2, torch.bfloat16, 1e-5

    def qt(K, N):
        q = torch.randint(-127, 128, (L, K, N), generator=gen, device="cuda", dtype=torch.int8)
        return QuantTensor(q, 2.7e-4 * (0.7 + 0.6 * torch.rand((L, K // GROUP, N), generator=gen, device="cuda")),
                           GROUP)

    w1, w3, w2 = qt(D, HD), qt(D, HD), qt(HD, D)
    rms = 1 + 0.1 * torch.randn((L, D), generator=gen, device="cuda").to(dtype)
    x = torch.randn((M, D), generator=gen, device="cuda").to(dtype)

    def kern(i): return mb.mlp_block_stacked(x, rms[i % L], w1, w3, w2, i % L, eps, residual=False)
    def plain(i): return mb.mlp_block_plain(x, rms[i % L], w1, w3, w2, i % L, eps, residual=False)

    def composed(i):
        l, h = i % L, ref.rmsnorm(x, rms[i % L], eps)
        return quant_matmul_stacked(ref.swiglu(quant_matmul_stacked(h, w1, l), quant_matmul_stacked(h, w3, l)),
                                    w2, l)

    forms = {f: getattr(mb.mlp_block_stacked, f"launches_{f}") for f in ("mma", "fma")}
    got, want = kern(3), plain(3)
    err = compare(got, want, dtype, mlp_tolerance(dtype, want))
    form = ",".join(f for f, n in forms.items() if getattr(mb.mlp_block_stacked, f"launches_{f}") > n)
    ms, qk = time_ms(kern, 128, cycles_per_ms)
    plain_ms, qp = time_ms(plain, 8, cycles_per_ms, n_warm=1)
    comp_ms, qc = time_ms(composed, 32, cycles_per_ms, slack=3.0)
    wbytes = 3 * D * HD
    nbytes = wbytes + 4 * wbytes // GROUP + 2 * M * 2 * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * wbytes / PEAK_FLOPS["bf16"] * 1e3
    bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    name = f"mlp_block_stacked[bf16,M={M},HD={HD},no_residual]"
    say("time", kernel=name, tag="K10/tp2", M=M, form=form or "not_counted", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", composed_route_ms=f"{comp_ms:.4f}", library_ms="none_(no_single_call)",
        bound_ms=f"{bound:.4f}", bound_by=by, share_of_bound=f"{bound / ms:.3f}", MB=f"{nbytes / 1e6:.1f}",
        GB_per_s=f"{nbytes / ms / 1e6:.0f}", max_abs_err=f"{err:.3e}", queued_kernel_plain_composed=f"{qk},{qp},{qc}")
    del w1, w3, w2
    torch.cuda.empty_cache()
    return {"name": name, "route": "cuda", "source": "llama2_tpu_torch/csrc/mlp_block.cu",
            "replaces": f"llama2_tpu/ops/pallas/mlp_block.py:{MLP_LINES['K10'][1]}", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None}


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
    (K10's at M = 1: the ffn-only route's; K10 at a rank's shape,
    ``mesh_k10_timing``: the mesh path's, ``phase_mesh``'s 1x2 leg on rank 0;
    the M = 201 rows: the accurate route's prefill-chunk tile launches; the
    8-row rows: the served runs', "served"; the classifier at M = 256: the
    perplexity runs', "ppl-fast" and "ppl-accurate").
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
            # the classifier also at the perplexity chunk: K5 over 256 positions
            for M in (1, PROMPT_TOKENS + 1) + ((PPL_CHUNK,) if name == "wcls" else ()):
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
                # the kernel line's rows: the main path's decode rows, the
                # accurate route's prefill chunk (K6 on the accurate M > 8
                # tile) and the perplexity chunk's classifier (K5 on the tile
                # of its mode)
                if M == PPL_CHUNK:
                    n_launch = launches[f"ppl-{mode}"]["K5"]
                elif name in (("wqkv", "wcls") if M == 1 else ("w13",) if mode == "accurate" else ()):
                    n_launch = launches[mode][("K6" if stacked else "K5") + ("-tile-acc" if M > 8 else "")]
                else:
                    n_launch = None
                if n_launch is not None:
                    rows.append({
                        "name": f"{kname}[{dn},{mode},{name},M={M}]", "route": "cuda", "source": src,
                        "replaces": "llama2_tpu/ops/pallas/quant_matmul.py:"
                        + ("340" if stacked else "476"),
                        "launches": n_launch,
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
    rows.append({**mesh_k10_timing(cycles_per_ms, gen), "launches": launches["mesh"]["K10-no-residual"]})
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


def phase_norm_timing() -> None:
    """K19 alone at the kernel benchmarks' two shapes (256 x 4096 and 1024 x
    8192 f32, the operands rotating through 512 MB or more) beside
    ``F.rms_norm``, its bound and its plain version (``phase_timing_bench``),
    then, under the same timer and rotation, what any kernel of this size
    pays: an empty launch (``torch.cuda._sleep(0)``) and one device copy of
    each shape's rows (``copy_``: the same bytes read and written as K19's).
    For two trees in one call: ``python3 chip_smoke.py --norm-timing`` runs
    it and nothing else, and the script placed in an older tree's root times
    that tree's kernel."""
    import torch

    from llama2_tpu_torch.benchmarks import kernels as kb
    from llama2_tpu_torch.ops.cuda import rmsnorm as rn

    phase_timing_bench(tags=("K19",))
    b = kb.Bench("cuda", seed=SEED + 17)
    ms, queued = b.time(lambda i: torch.cuda._sleep(0), 400)
    say("norm-floor", call="empty_launch", ms=f"{ms:.4f}", queued=queued)
    for R, D in ((256, 4096), (1024, 8192)):
        c = kb.rmsnorm_case(b, R, D)
        x = c.inputs["x"]
        out = torch.empty_like(x[0])
        ms, queued = b.time(lambda i: out.copy_(x[i % c.copies]), 200, c.copies)
        plan = rn.plan(R, D, torch.float32, True, torch.cuda.get_device_properties(0).multi_processor_count) \
            if hasattr(rn, "plan") else {"form": "one_block_a_row"}
        say("norm-floor", call="copy", shape=f"{R}x{D}", ms=f"{ms:.4f}", MB=f"{2 * x[0].numel() * 4 / 1e6:.2f}",
            GB_per_s=f"{2 * x[0].numel() * 4 / ms / 1e6:.0f}", k19_form=plan["form"], queued=queued)
        del c, x, out
    torch.cuda.empty_cache()


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
    cases = [(mode, name, False) for mode in ("fast", "accurate") for name in Q8_SHAPES]
    cases[6:6] = [("fast", "wqkv", True), ("fast", "w13", True)]
    q8_matmul_times(params, cases, PROMPT_TOKENS + 1, gen, cycles_per_ms, "prefill-time")
    del params
    torch.cuda.empty_cache()


def q8_matmul_times(params, cases, M: int, gen, cycles_per_ms: float, tag: str) -> None:
    """K5 (``wcls``) and K6 (the stacked weights) at M rows for each
    ``(mode, weight, rmsnorm prologue)`` of ``cases``, call i on layer i % 32
    of a 32-layer stack, beside the bound, the plain version and
    ``torch.matmul`` on the weight dequantized ahead (4 layers: more than
    the L2 holds)."""
    import torch

    from llama2_tpu_torch.ops.cuda.quant_matmul import (
        quant_matmul,
        quant_matmul_plain,
        quant_matmul_stacked,
        quant_matmul_stacked_plain,
    )
    from llama2_tpu_torch.quant.q8 import dequantize

    L = 32
    for mode, name, norm in cases:
        dtype = torch.bfloat16 if mode == "fast" else torch.float32
        dn = dtype_name(dtype)
        esize = torch.tensor([], dtype=dtype).element_size()
        K, N = Q8_SHAPES[name]
        w = params[name]
        stacked = w.q.ndim == 3
        x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
        kw = {"rms_w": (1 + 0.1 * torch.randn(K, generator=gen, device="cuda")).to(dtype)} if norm else {}
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
        say(tag, kernel=f"{'K6' if stacked else 'K5'}[{dn},{mode}]", weight=name,
            prologue=norm, M=M, K=K, N=N, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms_matmul_on_dequantized=f"{lib_ms:.4f}", bound_ms=f"{max(t_bytes, t_ops):.4f}",
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            **({"bound_ms_f32_simt": f"{max(t_bytes, simt):.4f}"} if simt else {}),
            TFLOP_per_s=f"{2 * M * K * N / ms / 1e9:.2f}", max_abs_err=f"{err:.3e}",
            queued_kernel_plain_library=f"{qk},{qp},{ql}")
        del wd


def phase_window_timing(cycles_per_ms: float) -> None:
    """K5 and K6 in fast mode (bf16 rows) at the row counts of the served
    paths: M = 8 (a decode tick of 8 slots: layer 0's rmsnorm-fused QKV and
    the classifier) and M = 32 (a speculative window of 8 slots x 4 tokens:
    the paged window's rmsnorm-fused QKV, the dense window's five
    projections a layer, the classifier), on every Q8_SHAPES weight, wqkv
    with and without the prologue, beside the bound, the plain version and
    ``torch.matmul`` on the dequantized weight (``q8_matmul_times``).
    ``python3 chip_smoke.py --window-timing`` runs it and nothing else."""
    import torch

    from llama2_tpu_torch.io.convert import random_q8_params

    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    params = all_layouts(random_q8_params(config_7b(32), SEED + 16, "cuda", torch.bfloat16, group_size=GROUP))
    cases = [("fast", name, False) for name in Q8_SHAPES] + [("fast", "wqkv", True)]
    for M in (8, 32):
        q8_matmul_times(params, cases, M, gen, cycles_per_ms, "window-time")
    del params
    torch.cuda.empty_cache()


# ---- slice 17: tensor- and data-parallel serving over a (data, model) mesh ----

POOL_DEADLINE_S = 3600.0  # a pool's ranks, all their tasks together
POOL_TASK_S = 900.0  # one task on every rank of a pool


class RankPool:
    """Ranks of one world size started once (``distributed.launch`` of
    ``pool_rank`` in a thread) and given the mesh phases' tasks in turn: a
    rank's start-up (the interpreter, torch, the card, the process group)
    costs seconds, paid once a world size instead of once a launch.
    ``run(fn, dp, tp, arg, axis)`` is ``distributed.launch(fn, dp, tp,
    device, arg, axis=axis)`` on the live ranks: every rank runs
    ``fn(mesh, arg)`` over a ``(axis, model)`` mesh of ``dp x tp`` (its
    groups made at the first task that names it) and the values come back
    rank 0's first; the first failure is raised. The tasks and results
    travel through queues of a ``multiprocessing`` manager."""

    def __init__(self, world: int, device: str):
        import threading

        from llama2_tpu_torch.parallel import distributed

        self.world = world
        self.manager = distributed.spawn_context().Manager()
        self.tasks = [self.manager.Queue() for _ in range(world)]
        self.results = self.manager.Queue()
        self.failed: list = []

        def serve():
            try:
                distributed.launch(pool_rank, world, 1, device, self.tasks, self.results, deadline=POOL_DEADLINE_S,
                                   libraries=())
            except BaseException as e:  # noqa: BLE001 -- raised by the next run()
                self.failed.append(e)

        self.thread = threading.Thread(target=serve, daemon=True)
        self.thread.start()

    def run(self, fn, dp: int, tp: int, arg, axis: str = "data") -> list:
        import queue

        from llama2_tpu_torch.parallel.distributed import RankError

        if dp * tp != self.world:
            raise ValueError(f"a {dp}x{tp} mesh on a pool of {self.world} ranks")
        for q in self.tasks:
            q.put((fn.__name__, dp, tp, axis, arg))
        got, end = {}, time.monotonic() + POOL_TASK_S
        while len(got) < self.world:
            if self.failed:
                raise self.failed[0]
            try:
                rank, ok, value = self.results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > end:
                    raise TimeoutError(f"{fn.__name__}: ranks {sorted(set(range(self.world)) - set(got))} did not "
                                       "finish") from None
                continue
            if not ok:
                raise RankError(f"{fn.__name__}: rank {rank} failed:\n{value}")
            got[rank] = value
        return [got[r] for r in range(self.world)]

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        self.thread.join(timeout=120)
        self.manager.shutdown()


_POOLS: dict = {}


def rank_pool(world: int, device: str = "cuda") -> RankPool:
    """The live pool of ``world`` ranks on ``device``, started at its first use."""
    if (world, device) not in _POOLS:
        _POOLS[world, device] = RankPool(world, device)
    return _POOLS[world, device]


def close_rank_pools() -> None:
    """End every pool's ranks (and its manager)."""
    while _POOLS:
        _POOLS.popitem()[1].close()


def pool_rank(mesh, tasks, results) -> None:
    """A pool's rank: run each task ``(function name, dp, tp, axis, arg)``
    of its queue on the mesh of that shape and post ``(rank, ok, value or
    traceback)``, until ``None``; a failed task ends the rank (the others
    then fail at their next collective). The card's cached blocks are freed
    after each task, for the one-card references the parent runs between
    them."""
    import traceback

    import torch

    from llama2_tpu_torch.parallel.mesh import make_mesh

    meshes: dict = {}
    while (task := tasks[mesh.rank].get()) is not None:
        name, dp, tp, axis, arg = task
        try:
            if (dp, tp, axis) not in meshes:  # every rank makes the groups, in the same order
                meshes[dp, tp, axis] = make_mesh(dp, tp, mesh.device.type, axis)
            results.put((mesh.rank, True, globals()[name](meshes[dp, tp, axis], arg)))
        except Exception:
            results.put((mesh.rank, False, traceback.format_exc()))
            raise
        torch.cuda.empty_cache()


MESH_DIR = os.path.join(REPO, "build", "mesh")
# (name, dp, tp, layers, the KV caches it serves over (int8 or not), speculative window)
# the 1x2 leg at 2 layers since slice 18 (32 before; phase_mesh_paged serves the dense engine at 1x2
# and 8 layers): room for that phase in the script's time
MESH_LEGS = (("1x2", 1, 2, 2, (False, True), 0), ("2x2", 2, 2, 2, (True,), 0), ("1x2-spec", 1, 2, 2, (True,), 4))
MESH_SERVER_ARGS = ("--mesh", "1x2", "--quant", "int8", "--kernels", "cuda", "--dtype", "f32", "--port", "0")
MESH_DEADLINE_S = 600.0
MESH_COMM_REQUESTS = 4  # the short run that times the reduces and gathers: 4 requests, 32 new tokens each
MESH_F32_WINDOW = 128  # the fp32 plain logits' teacher-forced segments


def mesh_requests() -> list:
    """The served workload's greedy requests (12 of 16)."""
    return [(p, g) for p, g in serve_workload() if g.temperature == 0.0]


def mesh_per_tick(L: int, kv_quant: bool) -> dict:
    """A sharded decode tick's launches at L layers: per layer K6 twice
    (wqkv with the rmsnorm prologue, wo without its residual), the glue-fused
    attention (K4, or K9 over the int8 cache) and K10 with ``residual=False``;
    K5 once on the vocab slice. The megakernels spanning the reduces never."""
    return {"K6": 2 * L, "K9" if kv_quant else "K4": L, "K10": L, "K10-no-residual": L, "K5": 1}


def mesh_chunk_k1(T: int, L: int, kv_quant: bool) -> int:
    """K1's launches in a T-token prefill chunk: once a layer over the fp
    cache past one token (a one-token chunk is a decode step)."""
    return L if T > 1 and not kv_quant else 0


class HopCount:
    """The ring collective matmul's hops (``collective_matmul.hops``), read
    and reset as a wrapper's ``launches``."""

    @property
    def launches(self) -> int:
        from llama2_tpu_torch.parallel import collective_matmul

        return collective_matmul.hops

    @launches.setter
    def launches(self, n: int) -> None:
        from llama2_tpu_torch.parallel import collective_matmul

        collective_matmul.hops = n


def mesh_counters() -> dict:
    from llama2_tpu_torch.ops.cuda.mlp_block import mlp_block_stacked

    return {**count_launches(), "K10-no-residual": VariantCount(mlp_block_stacked, "launches_no_residual"),
            "hops": HopCount()}


def mesh_served(eng, mesh, reqs, log: bool = False, comm: bool = False) -> dict:
    """Serve ``reqs`` on this rank's mesh engine (rank 0 submits, every rank
    runs to idle) with the launch counters at 0 just before and read just
    after: each decode tick's and each prefill chunk's launches apart, and
    the ticks' wall seconds. With ``comm`` the seconds in the collectives
    (``CommClock``: the reduces, gathers and broadcasts, and the ring's hops,
    each issue and each wait, apart from the chunk products between them),
    each timed between two synchronizations (which slow the tick they
    time); with ``log`` the logits row behind each
    generated token of the rank's slots (pipeline depth 1; a speculative
    window's rows behind the tokens it committed), by prompt. The dense and
    the paged engine alike."""
    import contextlib

    import torch

    from llama2_tpu_torch.runtime import batch_engine as be

    wrappers = mesh_counters()
    ticks, chunks, tick_s = [], [], []
    rows: dict = {}
    lo, hi = eng._rows.start, eng._rows.stop  # the rank's slots
    logits_from_hidden, window = be.logits_from_hidden, {}

    def counted(fn):
        def run(*a, **kw):
            before = {k: w.launches for k, w in wrappers.items()}
            res = fn(*a, **kw)
            ticks.append({k: w.launches - before[k] for k, w in wrappers.items()})
            return res
        return run

    decode_tick, chunk, sample, sample_first = eng._decode_tick, eng._chunk, eng._sample, eng._sample_first
    start, spec_tick, admitting = eng._start_request, eng._spec_tick, [None]

    def noted_start(slot, req):
        admitting[0] = slot
        start(slot, req)

    def counted_chunk(params, config, cache, seg, pos, mesh_=None):
        before = {k: w.launches for k, w in wrappers.items()}
        out = chunk(params, config, cache, seg, pos, mesh_)
        chunks.append((len(seg), {k: w.launches - before[k] for k, w in wrappers.items()}))
        return out

    def timed_tick():
        t0 = time.perf_counter()
        decode_tick()
        tick_s.append(time.perf_counter() - t0)

    def logged_sample(logits, sampled, draws):
        for b, r in enumerate(eng.slots):
            if r is not None and lo <= b < hi:
                rows[tuple(r.prompt)].append(logits[b - lo].detach().float().cpu())
        return sample(logits, sampled, draws)

    def logged_first(logits, req, pos):
        if lo <= admitting[0] < hi:
            rows[tuple(req.prompt)] = [logits.detach().float().cpu()]
        return sample_first(logits, req, pos)

    def kept_logits(params, hidden, backend="torch", mesh_=None):
        out = logits_from_hidden(params, hidden, backend, mesh_)
        window["logits"] = out.detach().float()  # (rank's slots, d, V)
        return out

    def logged_spec_tick():
        seated = [(b, r, len(r.tokens)) for b, r in enumerate(eng.slots) if r is not None and lo <= b < hi]
        be.logits_from_hidden = kept_logits
        try:
            spec_tick()
        finally:
            be.logits_from_hidden = logits_from_hidden
        for b, r, n0 in seated:
            rows[tuple(r.prompt)].extend(window["logits"][b - lo, : len(r.tokens) - n0].cpu())

    eng._dispatch_tick, eng._chunk, eng._decode_tick = counted(eng._dispatch_tick), counted_chunk, timed_tick
    if log:
        eng._sample, eng._sample_first, eng._start_request = logged_sample, logged_first, noted_start
        eng._spec_tick = logged_spec_tick
    for w in wrappers.values():
        w.launches = 0
    n_followed = len(eng.followed)
    clock = CommClock()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with clock if comm else contextlib.nullcontext():
            queues = [eng.submit(p, g) for p, g in reqs] if mesh.rank == 0 else []
            eng.run_until_idle()
            results = [q.get(timeout=60) for q in (queues or eng.followed[n_followed:])]
            torch.cuda.synchronize()
    finally:
        be.logits_from_hidden = logits_from_hidden
        for name in ("_dispatch_tick", "_chunk", "_decode_tick", "_sample", "_sample_first", "_start_request",
                     "_spec_tick"):
            eng.__dict__.pop(name, None)
    wall = time.perf_counter() - t0
    for r in results:
        if isinstance(r, Exception):
            raise AssertionError(f"rank {mesh.rank}: a request failed: {r!r}")
    return {"launches": {k: w.launches for k, w in wrappers.items()}, "ticks": ticks, "chunks": chunks,
            "tick_s": tick_s, "comm_s": clock.s, "wall_s": wall, "rows": rows,
            "tokens": {tuple(r.tokens[: r.prompt_len]): r.tokens for r in results}}


def mesh_hold(rows: dict, tokens: dict, ref: dict) -> list:
    """Each logged stream of a rank against the one-card reference ``ref``
    ({prompt: (tokens, logits rows, fp32 plain rows or None)}), over the
    rows both computed from the same prefix: the first generated token where
    they part (None), the largest |logits difference|, the one-card top-2
    margin where they part, and with fp32 rows the largest distance of each
    (this rank's and the one-card engine's) from them."""
    import torch

    out = []
    for prompt, mine in rows.items():
        want, want_rows, f32_rows = ref[prompt]
        got, gen = tokens[prompt][len(prompt):], want[len(prompt):]
        n = min(len(got), len(gen))
        part = next((i for i in range(n) if got[i] != gen[i]), None)
        k = min(n if part is None else part + 1, len(mine), len(want_rows))
        got_rows = torch.stack(mine[:k])
        margin = None
        if part is not None:
            top2 = want_rows[part].topk(2).values
            margin = float(top2[0] - top2[1])
        elif len(got) != len(gen):
            part = n  # one stream ended (BOS) where the other did not: no margin allows it
        h = {"generated": len(got), "part": part, "dist": float((got_rows - want_rows[:k]).abs().max()),
             "margin": margin, "rows": k, "absmax": float(want_rows[:k].abs().max())}
        if f32_rows is not None:
            h["vs_f32"] = float((got_rows - f32_rows[:k]).abs().max())
            h["one_card_vs_f32"] = float((want_rows[:k] - f32_rows[:k]).abs().max())
        out.append(h)
    return out


def mesh_f32_rows(path: str, kv_quant: bool, ref: dict) -> dict:
    """The fp32 plain logits (``backend="torch"``, float32 activations, the
    same Q8 weights, one card) along each one-card stream of ``ref``,
    teacher-forced in MESH_F32_WINDOW-token segments over the same kind of
    KV cache, one row for each of ``ref``'s rows: {prompt: rows}."""
    import torch

    from llama2_tpu_torch.io.cache import load_cache
    from llama2_tpu_torch.runtime.generator import BOS, prepare_params

    config, params, _ = load_cache(path)
    p32 = prepare_params(params, torch.float32, "torch", torch.device("cuda"))
    del params
    out = {p: teacher_forced_logits(p32, config, [BOS] + list(toks), len(p), "torch", kv_quant,
                                    window=MESH_F32_WINDOW)[: len(rows)]
           for p, (toks, rows) in ref.items()}
    del p32
    torch.cuda.empty_cache()
    return out


def skip_first_reduce(L: int):
    """A planted fault for ``llama.add_reduced``: every forward's first
    row-parallel all-reduce (layer 0's wo) left out, each rank adding only
    its own partial sum (every rank skips the same call: no collective
    waits)."""
    from llama2_tpu_torch.parallel.tp import add_reduced

    calls = [0]

    def skipping(x, partial, group):
        calls[0] += 1
        return add_reduced(x, partial, None if calls[0] % (2 * L) == 1 else group)

    return skipping


def mesh_rank(mesh, leg: dict) -> dict:
    """One rank of a mesh leg: pass the memory-mapped param cache to a mesh
    ``BatchEngine``, which copies out only this rank's slices; serve the
    leg's requests over each of its caches (a short warm-up first), assert
    the launches, hold the logged streams to the one-card references, time
    the reduces in a short run of their own; with ``plant``, a run with one
    all-reduce a forward left out (``skip_first_reduce``); with ``twin``,
    the server's twin. Returns what the parent reports and checks."""
    import torch
    import torch.distributed as dist

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io.cache import load_cache
    from llama2_tpu_torch.models import llama
    from llama2_tpu_torch.parallel import distributed
    from llama2_tpu_torch.runtime.batch_engine import BatchEngine

    backend, why = distributed.backend_rule(mesh.size, "cuda")
    if dist.get_backend() != backend:
        raise AssertionError(f"rank {mesh.rank}: {dist.get_backend()} where the rule says {why}")
    t0 = time.perf_counter()
    config, params, _ = load_cache(leg["path"])  # memory-mapped: the engine reads the rank's slices
    L = config.n_layers
    reqs = [(p, GenerationConfig(**g)) for p, g in leg["reqs"]]
    warm = [(p[:8], GenerationConfig(temperature=0.0, steps=12)) for p, _ in reqs[:SERVE_SLOTS]]
    short = [(p[:40], GenerationConfig(temperature=0.0, steps=72)) for p, _ in reqs[:MESH_COMM_REQUESTS]]
    leader = mesh.coord[1] == 0  # one rank of each data group logs its slots
    out = {"rank": mesh.rank, "coord": mesh.coord, "rule": why, "load_s": None, "runs": {}}

    def engine(**kw):
        eng = BatchEngine(config, params, mesh=mesh, backend="cuda", pipeline_depth=1, **kw)
        if eng.backend != "cuda" or eng.fwd_mesh is not mesh:
            raise AssertionError(f"rank {mesh.rank}: the engine runs {eng.backend} on {eng.fwd_mesh}")
        if eng.params["wcls"].q.shape[-1] != config.vocab_size // mesh.tp:
            raise AssertionError(f"rank {mesh.rank}: the classifier slice has {eng.params['wcls'].q.shape}")
        if out["load_s"] is None:  # the map, the slices copied out and sent to the card
            torch.cuda.synchronize()
            out["load_s"] = time.perf_counter() - t0
        return eng

    for kv in leg["caches"]:
        eng = engine(batch_size=SERVE_SLOTS, dtype=torch.bfloat16, kv_quant=kv, spec_window=leg["spec"])
        mesh_served(eng, mesh, warm)
        torch.cuda.reset_peak_memory_stats()
        run = mesh_served(eng, mesh, reqs, log=leader)
        launches = run["launches"]
        if leg["spec"]:
            if eng.metrics["spec_windows"] < 1 or launches["K11"] + launches["K12"] + launches["K13"]:
                raise AssertionError(f"rank {mesh.rank}: the spec leg ran no window, or a megakernel: {launches}")
        else:
            want = {k: mesh_per_tick(L, kv).get(k, 0) for k in launches}
            bad = [t for t in run["ticks"] if t != want]
            if not run["ticks"] or bad:
                raise AssertionError(f"rank {mesh.rank}: launches per decode tick {bad[:1]}, want {want}")
            k1 = {(T, c["K1"]) for T, c in run["chunks"]}
            if any(n != mesh_chunk_k1(T, L, kv) for T, n in k1):
                raise AssertionError(f"rank {mesh.rank}: (tokens, K1) of the prefill chunks {sorted(k1)}")
        timed = mesh_served(eng, mesh, short, comm=True)
        refs = torch.load(leg["refs"][kv]) if run["rows"] else None
        out["runs"][kv] = {
            "launches": launches, "n_ticks": len(run["ticks"]), "n_chunks": len(run["chunks"]),
            "spec_windows": eng.metrics["spec_windows"], "tick_s": run["tick_s"], "wall_s": run["wall_s"],
            "comm_s": timed["comm_s"], "comm_wall_s": timed["wall_s"], "comm_tick_s": timed["tick_s"],
            "peak_GiB": torch.cuda.max_memory_allocated() / 2**30,
            "held": mesh_hold(run["rows"], run["tokens"], refs) if refs else []}
        if leg.get("plant") and kv:
            # the same engine, plain ticks, one all-reduce a forward left out: the parent's check must fail
            eng.spec_window, add_reduced = 0, llama.add_reduced
            llama.add_reduced = skip_first_reduce(L)
            try:
                bad = mesh_served(eng, mesh, reqs, log=leader)
            finally:
                llama.add_reduced = add_reduced
            out["planted"] = mesh_hold(bad["rows"], bad["tokens"], refs) if refs else []
        del eng
        torch.cuda.empty_cache()
    if leg.get("twin"):
        # the server's twin: its settings (fp32, fp cache, 8 slots), its prompts, all at once
        eng = engine(batch_size=8, dtype=torch.float32)
        twin = mesh_served(eng, mesh, [(p, GenerationConfig(temperature=0.0, steps=48)) for p in leg["twin"]],
                           log=leader)
        out["twin"] = {"tokens": twin["tokens"] if mesh.rank == 0 else None,
                       "held": mesh_hold(twin["rows"], twin["tokens"], torch.load(leg["twin_ref"]))
                       if twin["rows"] else []}
    return out


def mesh_reference(path: str, kv_quant: bool, reqs, dtype=None, batch: int = SERVE_SLOTS, paged: dict | None = None
                   ) -> dict:
    """The one-card ``BatchEngine`` (``PagedBatchEngine`` with the settings
    ``paged``) on the cache at ``path`` (bf16 unless ``dtype``): {prompt:
    (tokens, logits rows)} (pipeline depth 1, every logits row behind a
    generated token kept), its wall seconds and ticks."""
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io.cache import load_cache
    from llama2_tpu_torch.runtime.batch_engine import BatchEngine
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

    config, params, _ = load_cache(path)
    kw = dict(batch_size=batch, dtype=dtype or torch.bfloat16, backend="cuda", device="cuda", kv_quant=kv_quant,
              pipeline_depth=1)
    eng = BatchEngine(config, params, **kw) if paged is None else PagedBatchEngine(config, params, **kw, **paged)
    del params
    served_run(eng, [(p[:8], GenerationConfig(temperature=0.0, steps=12)) for p, _ in reqs[:batch]])
    run = served_run(eng, reqs, log=True)
    ref = {tuple(p): (t, rows) for (p, _), t, rows in zip(reqs, run["tokens"], run["logits"])}
    del eng
    torch.cuda.empty_cache()
    return {"ref": ref, "wall_s": run["wall_s"], "n_ticks": len(run["ticks"])}


def mesh_cap(name: str, held: list, cap: str) -> str:
    """The logits tolerance of a leg's logged streams, over the rows each
    computed from the same prefix as the one-card engine: ``"bf16"``: the
    largest distance from the fp32 plain logits at most the one-card bf16
    engine's + BF16_MAX_MARGIN (the bf16 rule of the single-card paths);
    ``"f32"`` (fast-mode kernels on fp32 activations): the largest distance
    from the one-card engine at most F32_FAST_LOGIT_RTOL x max |logit|.
    Returns the fault, or "" where the leg holds."""
    dist, absmax = max(h["dist"] for h in held), max(h["absmax"] for h in held)
    if cap == "bf16":
        got, one = max(h["vs_f32"] for h in held), max(h["one_card_vs_f32"] for h in held)
        limit, what = one + BF16_MAX_MARGIN, f"vs_f32 {got:.4e}, one card's {one:.4e} + {BF16_MAX_MARGIN}"
    else:
        got, limit, what = dist, F32_FAST_LOGIT_RTOL * absmax, f"{dist:.4e} vs {F32_FAST_LOGIT_RTOL} x {absmax:.3f}"
    return f"{name}: the logits are past their tolerance ({what})" if got > limit else ""


def mesh_margin_rule(name: str, held: list, cap: str) -> list:
    """A leg's logged streams: the logits tolerance (``mesh_cap``), then the
    margin rule: where a stream parts from the one-card stream, the one-card
    top-2 margin there is at most twice the largest logits difference over
    the rows both computed from the same prefix (a stream that ends where
    the other does not fails). Prints the readings; returns the faults."""
    dist = max(h["dist"] for h in held)
    faults = [f for f in [mesh_cap(name, held, cap)] if f]
    for h in held:
        if h["part"] is not None and (h["margin"] is None or h["margin"] > 2 * dist):
            faults.append(f"{name}: a stream parts from the one-card engine where the margin allows no flip: "
                          f"{h}, bound {2 * dist}")
    n_gen = sum(h["generated"] for h in held)
    same = sum(h["generated"] if h["part"] is None else h["part"] for h in held)
    if cap == "bf16":
        f32 = {"logit_max_abs_diff_vs_f32_plain": f"{max(h['vs_f32'] for h in held):.4e}",
               "one_card_bf16_vs_f32_plain": f"{max(h['one_card_vs_f32'] for h in held):.4e}",
               "cap": f"one_card+{BF16_MAX_MARGIN}"}
    else:
        f32 = {"cap": f"{F32_FAST_LOGIT_RTOL}*logit_absmax"}
    say("mesh", leg=name, streams=len(held), generated=n_gen, tokens_equal_to_one_card=f"{same}/{n_gen}",
        parted=sum(h["part"] is not None for h in held), rows_compared=sum(h["rows"] for h in held),
        logit_max_abs_diff=f"{dist:.4e}", logit_absmax=f"{max(h['absmax'] for h in held):.3f}", **f32,
        rule="cap+margin", held="yes" if not faults else "NO")
    return faults


def mesh_server(path: str, twin_prompts: list, twin: dict) -> None:
    """The server as a user starts it, ``--mesh 1x2 --quant int8 --kernels
    cuda --dtype f32`` on the 2-layer cache: three concurrent greedy answers
    equal the in-process mesh engine's (the twin's), /health answers, SIGINT
    exits 0 (the server joins its follower before it exits)."""
    bodies = [{"prompt": p, "temperature": 0.0, "steps": 48} for p in SERVER_PROMPTS]
    run = run_server(path, (), bodies, args=MESH_SERVER_ARGS)
    for i, p in enumerate(twin_prompts):
        if run["results"][i]["tokens"] != twin[tuple(p)]:
            raise AssertionError(f"--mesh 1x2: served tokens for {SERVER_PROMPTS[i]!r} differ from the "
                                 "in-process mesh engine's")
    if not any("[mesh] 2 ranks" in line for line in run["lines"]) or run["health"].get("status") != "ok":
        raise AssertionError(f"--mesh 1x2 server: {run['lines']}, {run['health']}")
    say("server", args="_".join(MESH_SERVER_ARGS[:-2]), up_s=f"{run['up_s']:.1f}",
        greedy_requests=len(SERVER_PROMPTS), tokens_equal_to_in_process_mesh_engine="all", sigint_exit=run["rc"])


def phase_mesh() -> dict:
    """This slice's main path: ``BatchEngine(mesh=)`` over a ``(data,
    model)`` mesh of ranks on the one card (two or four ranks on cuda:0 over
    gloo, the rule printed), at full Llama-2-7B width with random INT8
    weights (bf16 activations, ``backend="cuda"``) written once as a param
    cache (``tools/make_random_q8.py --device cuda``), memory-mapped by each
    rank, whose engine copies out only its slices, serving the served
    workload's 12 greedy requests on 8 slots. Legs (MESH_LEGS): 1x2 at 2
    layers over the fp and the int8 cache, 2x2 at 2 layers over the int8
    cache, 1x2 at 2 layers with 4-token speculative windows over the int8
    cache, and the server's twin (1x2, 2 layers, fp32, the fp cache).
    Asserted on every rank: ``engine.backend == "cuda"``, the backend rule,
    each decode tick's launches (``mesh_per_tick``: K10 with
    ``residual=False`` on every layer; K11-K13 never), K1 once a layer of
    every fp-cache prefill chunk, the classifier's 16000-column slice. Every
    logged stream is held to the one-card ``BatchEngine`` on the same weights
    (``mesh_reference``), over the rows both computed from the same prefix:
    a stated logits tolerance (``mesh_cap``: bf16 legs against the fp32
    plain logits, ``mesh_f32_rows``; the fp32 twin against the one-card
    fp32 engine), then the margin rule (``mesh_margin_rule``). A planted
    fault, one all-reduce a forward left out (``skip_first_reduce``, on the
    spec leg's ranks), must fail the tolerance. Then the server
    (``mesh_server``). Printed per leg and rank: tick ms (host wall), the
    reduces' share of a short timed run (``mesh_served(comm=True)``), load
    seconds, peak memory. Two ranks time-slice one card and reduce through
    the host: these times say nothing of NVLink scaling. Every leg is
    checked and printed before a fault fails the phase. Returns the 1x2
    fp-cache run's launches (rank 0's)."""
    import shutil

    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.parallel import distributed
    from llama2_tpu_torch.tokenizer.tokenizer import Tokenizer
    from llama2_tpu_torch.tools.make_random_q8 import build

    smi = nvidia_smi()
    mark = stopwatch("phase_mesh")
    shutil.rmtree(MESH_DIR, ignore_errors=True)  # nothing of an earlier run: caches and references made anew
    os.makedirs(MESH_DIR)
    reqs = mesh_requests()
    plain = [(p, {"temperature": 0.0, "steps": g.steps}) for p, g in reqs]
    tok = Tokenizer.from_file(TOKENIZER_BIN, 32000)
    twin_prompts = [tok.encode(p) for p in SERVER_PROMPTS]
    paths = {}
    for L in sorted({leg[3] for leg in MESH_LEGS}):
        paths[L] = os.path.join(MESH_DIR, f"7b-{L}L")
        build(paths[L], "7b", GROUP, SEED, seq_len=4096, n_layers=L, device="cuda")
        torch.cuda.empty_cache()
    mark("write_caches")
    out, refs, faults = {}, {}, []
    for name, dp, tp, L, caches, spec in MESH_LEGS:
        leg = {"path": paths[L], "caches": caches, "spec": spec, "reqs": plain, "refs": {}}
        for kv in caches:
            if (L, kv) not in refs:  # the spec leg holds to the 2x2 leg's: the same weights and cache
                ref = mesh_reference(paths[L], kv, reqs)
                ref["f32"] = mesh_f32_rows(paths[L], kv, ref["ref"])
                ref["file"] = os.path.join(MESH_DIR, f"ref-{L}L-{'int8' if kv else 'fp'}.pt")
                torch.save({p: (t, rows, ref["f32"][p]) for p, (t, rows) in ref["ref"].items()}, ref["file"])
                refs[(L, kv)] = ref
            leg["refs"][kv] = refs[(L, kv)]["file"]
        if spec:
            leg["twin"], leg["plant"] = twin_prompts, True
            leg["twin_ref"] = os.path.join(MESH_DIR, "ref-twin.pt")
            twin_reqs = [(p, GenerationConfig(temperature=0.0, steps=48)) for p in twin_prompts]
            twin_ref = mesh_reference(paths[L], False, twin_reqs, torch.float32, 8)["ref"]
            torch.save({p: (t, rows, None) for p, (t, rows) in twin_ref.items()}, leg["twin_ref"])
        mark(f"{name}/one_card")
        ranks = rank_pool(dp * tp).run(mesh_rank, dp, tp, leg)
        mark(f"{name}/mesh")
        rule = distributed.backend_rule(dp * tp, "cuda")[1]
        if any(r["rule"] != rule for r in ranks):
            raise AssertionError(f"{name}: the ranks' backend rule {[r['rule'] for r in ranks]}, want {rule!r}")
        print(rule, flush=True)
        for kv in caches:
            dn = f"{name}/{L}L/{'int8' if kv else 'fp'}-cache"
            runs = [r["runs"][kv] for r in ranks]
            faults += mesh_margin_rule(dn, [h for r in runs for h in r["held"]], "bf16")
            for r, run in zip(ranks, runs):
                tick, comm_tick = sorted(run["tick_s"]), sorted(run["comm_tick_s"])
                say("mesh", leg=dn, rank=r["rank"], coord=f"{r['coord'][0]},{r['coord'][1]}",
                    decode_ticks=run["n_ticks"], spec_windows=run["spec_windows"], prefill_chunks=run["n_chunks"],
                    wall_s=f"{run['wall_s']:.3f}",
                    tick_ms_median=f"{1e3 * tick[len(tick) // 2]:.3f}" if tick else "none",
                    timed_run_tick_ms_median=f"{1e3 * comm_tick[len(comm_tick) // 2]:.3f}" if comm_tick else "none",
                    reduce_share_of_timed_run=f"{run['comm_s'] / run['comm_wall_s']:.3f}",
                    load_s=f"{r['load_s']:.1f}", peak_GiB=f"{run['peak_GiB']:.2f}",
                    **{f"{k}_launches": v for k, v in run["launches"].items() if v})
            ref = refs[(L, kv)]
            say("mesh", leg=dn, one_card_wall_s=f"{ref['wall_s']:.3f}", one_card_ticks=ref["n_ticks"],
                mesh_wall_s=f"{runs[0]['wall_s']:.3f}", rule=rule.replace(" ", "_"), card=smi.replace(" ", "_"))
        if spec:
            faults += mesh_margin_rule(f"{name}/server-twin/{L}L/fp32/fp-cache",
                                       [h for r in ranks for h in r["twin"]["held"]], "f32")
            planted = [h for r in ranks for h in r["planted"]]
            caught = mesh_cap(f"{name}/planted", planted, "bf16")
            say("mesh", leg=f"{name}/{L}L/int8-cache", planted_fault="one_all_reduce_a_forward_left_out",
                vs_f32=f"{max(h['vs_f32'] for h in planted):.4e}",
                one_card_vs_f32=f"{max(h['one_card_vs_f32'] for h in planted):.4e}",
                tolerance="fails" if caught else "PASSES")
            if not caught:
                faults.append(f"{name}: the logits tolerance passes a planted fault (one all-reduce left out)")
        out[name] = ranks
    mark("legs")
    if faults:
        raise AssertionError("; ".join(faults))
    mesh_server(paths[2], twin_prompts, out["1x2-spec"][0]["twin"]["tokens"])
    mark("server")
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    return out["1x2"][0]["runs"][False]["launches"]


# ---- slice 18: the paged engine over a (data, model) mesh, and the ring collective matmul ----

MESH_PAGED_DIR = os.path.join(REPO, "build", "mesh_paged")
# One launch of ranks a mesh shape; each run an engine on every rank: its kind, pool or cache (int8 or
# not), speculative window, prefix cache and collective (None: the psum form); "twin": the run of the
# same launch a ring run is held to (its psum form); "plant": a fault the tolerance must catch
_RUN = dict(kind="paged", kv=False, spec=0, prefix=False, collective=None)
MESH_PAGED_LAUNCHES = (
    # 1x2 at 2 layers since slice 19 (8 before): room for phase_long_context in the script's time
    dict(name="1x2", dp=1, tp=2, L=2, runs=(
        dict(_RUN, name="paged"),
        dict(_RUN, name="paged-int8", kv=True),
        dict(_RUN, name="paged-ring", collective="ring", twin="paged", plant="ring_hop"),
        dict(_RUN, name="dense", kind="dense"),
        dict(_RUN, name="dense-ring", kind="dense", collective="ring", twin="dense"),
    )),
    dict(name="2x2", dp=2, tp=2, L=2, runs=(
        dict(_RUN, name="paged-prefix", prefix=True, plant="stage_write"),
        dict(_RUN, name="paged-spec", spec=4),
    )),
)
MESH_PAGED_SERVER_ARGS = ("--paged", "--mesh", "1x2", "--collective-matmul", "--quant", "int8", "--kernels", "cuda",
                          "--dtype", "f32", "--port", "0")
MESH_PLANT_REQUESTS = 4  # a planted fault's run: the first requests (the fault lands in the first)


def mesh_paged_per_tick(L: int, tp: int, kind: str, kv_quant: bool, ring: bool) -> dict:
    """A rank's decode tick at L layers: K6 twice a layer (wqkv with the
    rmsnorm prologue; then wo without its residual, or on the ring form w13,
    wo's and w2's products being the ring's dequantize and matmul), the
    glue-fused attention at the rank's heads (paged: K17, K18 over an int8
    pool; dense: K4), K10 with ``residual=False`` (psum form only), K5 once on
    the vocab slice; the ring form's hops 2 (tp - 1) a row-parallel linear,
    two a layer. K11-K13 never."""
    att = ("K18" if kv_quant else "K17") if kind == "paged" else ("K9" if kv_quant else "K4")
    if ring:
        return {"K6": 2 * L, att: L, "K5": 1, "hops": 2 * (tp - 1) * 2 * L}
    return {"K6": 2 * L, att: L, "K10": L, "K10-no-residual": L, "K5": 1}


def pool_nbytes(pool) -> int:
    return sum(t.numel() * t.element_size() for t in (pool.k, pool.v, pool.ks, pool.vs) if t is not None)


def planted(fault: str, mesh):
    """Install a planted fault; returns its undo. ``"stage_write"``: the
    first admission's staged rows written by the data group that does NOT
    own the slot (the owner keeps its zeroed pages); ``"ring_hop"``: on
    rank 0's first forward, the first hop's received accumulator dropped
    (zeros in its place: every rank still sends and receives, so no rank
    waits)."""
    import torch

    from llama2_tpu_torch.parallel import collective_matmul as cm
    from llama2_tpu_torch.parallel import dp_paged

    calls = [0]
    if fault == "stage_write":
        orig = dp_paged.stage_write

        def misrouted(pool, staging, row0, bucket, pids, rids, own=True):
            calls[0] += 1
            return orig(pool, staging, row0, bucket, pids, rids, own=not own if calls[0] == 1 else own)

        dp_paged.stage_write = misrouted
        return lambda: setattr(dp_paged, "stage_write", orig)
    orig = cm._hop

    def dropped(ring, t, staged, overlap=None):
        received, value = orig(ring, t, staged, overlap)
        calls[0] += 1
        if calls[0] == 1 and mesh.rank == 0:
            received = torch.zeros_like(received)
        return received, value

    cm._hop = dropped
    return lambda: setattr(cm, "_hop", orig)


def mesh_paged_rank(mesh, launch: dict) -> dict:
    """One rank of a paged-mesh launch: each run is an engine on the
    memory-mapped param cache (the rank copies out its slices), a short
    warm-up, then the 12 greedy requests with the launches of every decode
    tick asserted, a paged pool's bytes (1/(dp*tp) of the one-card pool at
    the same page count) and page ids (below the group's share) checked,
    the logged streams held to the one-card references, the reduces' or
    hops' share timed in a short run of their own; a ring run also held to
    its psum twin (an earlier run of the launch); with ``plant``, a run of
    the first requests with the planted fault in place."""
    import torch
    import torch.distributed as dist

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io.cache import load_cache
    from llama2_tpu_torch.parallel import distributed
    from llama2_tpu_torch.runtime.batch_engine import BatchEngine
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

    backend, why = distributed.backend_rule(mesh.size, "cuda")
    if dist.get_backend() != backend:
        raise AssertionError(f"rank {mesh.rank}: {dist.get_backend()} where the rule says {why}")
    config, params, _ = load_cache(launch["path"])  # memory-mapped: the engine reads the rank's slices
    L = config.n_layers
    reqs = [(p, GenerationConfig(**g)) for p, g in launch["reqs"]]
    warm = [(p[:8], GenerationConfig(temperature=0.0, steps=12)) for p, _ in reqs[:SERVE_SLOTS]]
    short = [(p[:40], GenerationConfig(temperature=0.0, steps=72)) for p, _ in reqs[:MESH_COMM_REQUESTS]]
    leader = mesh.coord[1] == 0  # one rank of each data group logs its slots
    out = {"rank": mesh.rank, "coord": mesh.coord, "rule": why, "runs": {}}
    twins: dict = {}

    def engine(run: dict):
        kw = dict(mesh=mesh, backend="cuda", pipeline_depth=1, batch_size=SERVE_SLOTS, dtype=torch.bfloat16,
                  kv_quant=run["kv"], spec_window=run["spec"], collective=run["collective"])
        if run["kind"] == "paged":
            eng = PagedBatchEngine(config, params, page_size=SERVE_PAGE, prefix_cache=run["prefix"], **kw)
            if not eng._MESH_TICKS or eng._dp != (mesh.dp if mesh.dp > 1 else 0):
                raise AssertionError(f"rank {mesh.rank}: the paged mesh path is off ({eng._dp})")
        else:
            eng = BatchEngine(config, params, **kw)
        if eng.backend != "cuda" or eng.fwd_mesh is not mesh or eng.collective != run["collective"]:
            raise AssertionError(f"rank {mesh.rank}: the engine runs {eng.backend} on {eng.fwd_mesh}")
        if eng.params["wcls"].q.shape[-1] != config.vocab_size // mesh.tp:
            raise AssertionError(f"rank {mesh.rank}: the classifier slice has {eng.params['wcls'].q.shape}")
        return eng

    def noted_pages(eng) -> list:
        taken, alloc = [], eng._alloc

        def noted(n, slot=0):
            pages = alloc(n, slot)
            taken.extend(pages)
            return pages

        eng._alloc = noted
        return taken

    for run in launch["runs"]:
        name, kind = run["name"], run["kind"]
        eng = engine(run)
        taken = noted_pages(eng) if kind == "paged" else []
        mesh_served(eng, mesh, warm)
        torch.cuda.reset_peak_memory_stats()
        served = mesh_served(eng, mesh, reqs, log=leader)
        launches = served["launches"]
        if run["spec"]:
            if eng.metrics["spec_windows"] < 1 or launches["K11"] + launches["K12"] + launches["K13"]:
                raise AssertionError(f"rank {mesh.rank}: the spec run ran no window, or a megakernel: {launches}")
        else:
            want = {k: mesh_paged_per_tick(L, mesh.tp, kind, run["kv"], run["collective"] == "ring").get(k, 0)
                    for k in launches}
            bad = [t for t in served["ticks"] if t != want]
            if not served["ticks"] or bad:
                raise AssertionError(f"rank {mesh.rank} {name}: launches per decode tick {bad[:1]}, want {want}")
            # a paged engine prefills through its fp staging plane whatever its pool
            k1 = {(T, c["K1"]) for T, c in served["chunks"]}
            if any(n != mesh_chunk_k1(T, L, run["kv"] and kind == "dense") for T, n in k1):
                raise AssertionError(f"rank {mesh.rank}: (tokens, K1) of the prefill chunks {sorted(k1)}")
        record = {"launches": launches, "n_ticks": len(served["ticks"]), "n_chunks": len(served["chunks"]),
                  "spec_windows": eng.metrics["spec_windows"], "tick_s": served["tick_s"],
                  "wall_s": served["wall_s"], "peak_GiB": torch.cuda.max_memory_allocated() / 2**30}
        if kind == "paged":
            c, esize = config, 1 if run["kv"] else 2
            rows = c.n_layers * eng.n_pages * c.n_kv_heads * SERVE_PAGE
            whole = 2 * rows * c.head_size * esize + (2 * rows * 4 if run["kv"] else 0)  # the one-card pool
            mine = pool_nbytes(eng.pool)
            if mine * mesh.dp * mesh.tp != whole or not taken or max(taken) >= eng.pool.n_pages:
                raise AssertionError(f"rank {mesh.rank}: pool {mine} B of {whole}, pages up to {max(taken, default=0)}"
                                     f" of the group's {eng.pool.n_pages}")
            record.update(pool_GiB=mine / 2**30, pool_pages=eng.pool.n_pages, max_page=max(taken),
                          prefix_hits=eng.metrics.get("prefix_hit_pages_by_shard", [eng.metrics["prefix_hit_pages"]]))
        timed = mesh_served(eng, mesh, short, comm=True)
        record.update(comm_s=timed["comm_s"], comm_wall_s=timed["wall_s"], comm_tick_s=timed["tick_s"])
        refs = torch.load(launch["refs"][name]) if served["rows"] else None
        record["held"] = mesh_hold(served["rows"], served["tokens"], refs) if refs else []
        if served["rows"]:
            twins[name] = {p: (served["tokens"][p], torch.stack(rows), None) for p, rows in served["rows"].items()}
            if run.get("twin"):
                record["vs_psum"] = mesh_hold(served["rows"], served["tokens"], twins[run["twin"]])
        out["runs"][name] = record
        if run.get("plant"):
            # the same settings, the planted fault in place: the parent's check must fail
            if run["plant"] == "stage_write":  # a fresh engine: nothing cached from the runs before
                del eng
                eng = engine(run)
            undo = planted(run["plant"], mesh)
            try:
                bad = mesh_served(eng, mesh, reqs[:MESH_PLANT_REQUESTS], log=leader)
            finally:
                undo()
            out[f"planted-{name}"] = mesh_hold(bad["rows"], bad["tokens"], refs) if refs else []
        del eng
        torch.cuda.empty_cache()
    return out


def twin_rule(name: str, held: list) -> list:
    """A ring run against its psum twin (the same engine, weights and
    requests with the all-reduce form) over the rows both computed from the
    same prefix: the margin rule (where the streams part, the twin's top-2
    margin at most twice the largest logits difference). Prints the
    readings; returns the faults."""
    dist = max(h["dist"] for h in held)
    faults = [f"{name}: the ring parts from its psum twin where the margin allows no flip: {h}"
              for h in held if h["part"] is not None and (h["margin"] is None or h["margin"] > 2 * dist)]
    n_gen = sum(h["generated"] for h in held)
    same = sum(h["generated"] if h["part"] is None else h["part"] for h in held)
    say("mesh-paged", leg=name, against="psum_twin", tokens_equal=f"{same}/{n_gen}",
        parted=sum(h["part"] is not None for h in held), logit_max_abs_diff=f"{dist:.4e}",
        rule="margin", held="yes" if not faults else "NO")
    return faults


def mesh_paged_server(path: str) -> None:
    """The server as a user starts it, ``--paged --mesh 1x2
    --collective-matmul --quant int8 --kernels cuda --dtype f32`` on the
    2-layer cache: three concurrent greedy answers, /health, SIGINT exits 0,
    the rule and the hop staging printed. Each answer is held to the plain
    path (its tokens teacher-forced through the one-card paged engine on
    ``backend="torch"``, fp32): every token the plain argmax wherever the
    plain top-2 margin exceeds twice F32_FAST_LOGIT_RTOL x the largest
    logit (fast-mode K6 against the plain products: the fp32 bound)."""
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io.cache import load_cache
    from llama2_tpu_torch.tokenizer.tokenizer import Tokenizer

    bodies = [{"prompt": p, "temperature": 0.0, "steps": 48} for p in SERVER_PROMPTS]
    run = run_server(path, (), bodies, args=MESH_PAGED_SERVER_ARGS)
    lines = "".join(run["lines"])
    if "[mesh] 2 ranks" not in lines or "[ring] gloo: hops staged through the host" not in lines \
            or run["health"].get("status") != "ok":
        raise AssertionError(f"--paged --mesh 1x2 --collective-matmul server: {lines[-2000:]}, {run['health']}")
    config, params, _ = load_cache(path)
    tok = Tokenizer.from_file(TOKENIZER_BIN, config.vocab_size)
    reqs = [(tok.encode(p), GenerationConfig(temperature=0.0, steps=48)) for p in SERVER_PROMPTS]
    streams = [run["results"][i]["tokens"] for i in range(len(reqs))]
    plain = forced_replay(config, params, reqs, streams, "torch", batch_size=8, page_size=SERVE_PAGE,
                          dtype=torch.float32)
    absmax = max(float(lp.abs().max()) for lp in plain)
    bound = 2 * F32_FAST_LOGIT_RTOL * absmax
    checked = agree = total = 0
    for (prompt, _), toks, lp in zip(reqs, streams, plain):
        gen = torch.tensor(toks[len(prompt):])
        top2 = lp[: len(gen)].topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > bound
        ok = lp[: len(gen)].argmax(-1) == gen
        checked, agree, total = checked + int(clear.sum()), agree + int(ok[clear].sum()), total + len(gen)
        if not bool(ok[clear].all()):
            raise AssertionError("--paged --mesh 1x2 --collective-matmul: a served token differs from the plain "
                                 "path where the margin allows no flip")
    say("server", args="_".join(MESH_PAGED_SERVER_ARGS[:-2]), up_s=f"{run['up_s']:.1f}",
        greedy_requests=len(SERVER_PROMPTS), tokens_checked=f"{checked}/{total}",
        equal_to_plain_there=f"{agree}/{checked}", margin_bound=f"{bound:.4f}", hop_staging="printed",
        sigint_exit=run["rc"])


def phase_mesh_paged() -> dict:
    """This slice's main path: ``PagedBatchEngine(mesh=)`` (pages over
    ``data`` with an allocator a data group, kv heads over ``model``) and the
    ring collective matmul (``collective="ring"``) on both engines, over
    ranks on the one card (gloo, the rule printed), at full Llama-2-7B width
    with random INT8 weights (bf16 activations, ``backend="cuda"``, 8 slots,
    256-row pages) written once as param caches, serving the served
    workload's 12 greedy requests. Two launches (MESH_PAGED_LAUNCHES), each
    spawning its ranks once: 1x2 at 2 layers (the paged engine over the bf16
    and the int8 pool, then with the ring; the dense engine, then with the
    ring) and 2x2 at 2 layers (the paged engine with the prefix cache, the
    even requests' 256-token prefix hitting in both data groups, and with
    4-token speculative windows); then the ``--paged --mesh 1x2
    --collective-matmul`` server. Asserted on every rank: the backend rule,
    the paged mesh path taken, each decode tick's launches
    (``mesh_paged_per_tick``), K1 a layer of every prefill chunk, the pool's
    bytes and page ids. Every logged stream is held to the one-card engine
    of its kind on the same weights (a stated logits tolerance,
    ``mesh_cap``: the distance from the fp32 plain logits at most the
    one-card bf16 engine's + BF16_MAX_MARGIN; then the margin rule), the
    ring runs also to their psum twins (``twin_rule``). Two planted faults
    must fail the tolerance: a stage write sent to the wrong data group
    (2x2) and one ring hop dropped on a rank's first forward. Printed per
    run and rank: tick ms (host wall), the reduces' or hops' share of a
    short timed run, prefix-hit pages per data group, pool and peak GiB.
    Ranks time-slice one card and reduce through the host: these times say
    nothing of an overlap or of NVLink. Returns rank 0's launches of the
    paged runs, summed."""
    import shutil

    import torch

    from llama2_tpu_torch.parallel import distributed
    from llama2_tpu_torch.tools.make_random_q8 import build

    smi = nvidia_smi()
    mark = stopwatch("phase_mesh_paged")
    shutil.rmtree(MESH_PAGED_DIR, ignore_errors=True)
    os.makedirs(MESH_PAGED_DIR)
    reqs = mesh_requests()
    plain = [(p, {"temperature": 0.0, "steps": g.steps}) for p, g in reqs]
    paths = {}
    for L in sorted({launch["L"] for launch in MESH_PAGED_LAUNCHES}):
        paths[L] = os.path.join(MESH_PAGED_DIR, f"7b-{L}L")
        build(paths[L], "7b", GROUP, SEED, seq_len=4096, n_layers=L, device="cuda")
        torch.cuda.empty_cache()
    mark("write_caches")
    refs: dict = {}

    def ref_file(L: int, run: dict) -> str:
        key = (L, run["kind"], run["kv"], run["prefix"])  # the spec and ring runs share their kind's
        if key not in refs:
            paged = dict(page_size=SERVE_PAGE, prefix_cache=run["prefix"]) if run["kind"] == "paged" else None
            ref = mesh_reference(paths[L], run["kv"], reqs, paged=paged)
            f32 = mesh_f32_rows(paths[L], run["kv"], ref["ref"])
            ref["file"] = os.path.join(MESH_PAGED_DIR, f"ref-{L}L-{'-'.join(map(str, key[1:]))}.pt")
            torch.save({p: (t, rows, f32[p]) for p, (t, rows) in ref["ref"].items()}, ref["file"])
            refs[key] = ref
        return refs[key]["file"]

    total: dict = {}
    faults: list = []
    for launch in MESH_PAGED_LAUNCHES:
        dp, tp, L = launch["dp"], launch["tp"], launch["L"]
        spec = dict(launch, path=paths[L], reqs=plain, refs={run["name"]: ref_file(L, run) for run in launch["runs"]})
        mark(f"{launch['name']}/one_card")
        ranks = rank_pool(dp * tp).run(mesh_paged_rank, dp, tp, spec)
        mark(f"{launch['name']}/mesh")
        rule = distributed.backend_rule(dp * tp, "cuda")[1]
        if any(r["rule"] != rule for r in ranks):
            raise AssertionError(f"{launch['name']}: the ranks' backend rule {[r['rule'] for r in ranks]}, "
                                 f"want {rule!r}")
        print(rule, flush=True)
        for run in launch["runs"]:
            kind, name = run["kind"], run["name"]
            dn = (f"{launch['name']}/{name}/{L}L/{'int8' if run['kv'] else 'bf16'}-"
                  f"{'pool' if kind == 'paged' else 'cache'}")
            runs = [r["runs"][name] for r in ranks]
            faults += mesh_margin_rule(dn, [h for r in runs for h in r["held"]], "bf16")
            if run.get("twin"):
                faults += twin_rule(dn, [h for r in runs for h in r.get("vs_psum", [])])
            for r, rec in zip(ranks, runs):
                tick, comm_tick = sorted(rec["tick_s"]), sorted(rec["comm_tick_s"])
                paged = {"pool_GiB": f"{rec['pool_GiB']:.3f}", "pool_pages": rec["pool_pages"],
                         "max_page_id": rec["max_page"],
                         "prefix_hit_pages_by_data_group": ",".join(map(str, rec["prefix_hits"]))} \
                    if kind == "paged" else {}
                say("mesh-paged", leg=dn, rank=r["rank"], coord=f"{r['coord'][0]},{r['coord'][1]}",
                    decode_ticks=rec["n_ticks"], spec_windows=rec["spec_windows"], prefill_chunks=rec["n_chunks"],
                    wall_s=f"{rec['wall_s']:.3f}",
                    tick_ms_median=f"{1e3 * tick[len(tick) // 2]:.3f}" if tick else "none",
                    timed_run_tick_ms_median=f"{1e3 * comm_tick[len(comm_tick) // 2]:.3f}" if comm_tick else "none",
                    **{("hops" if run["collective"] else "reduces") + "_share_of_timed_run":
                       f"{rec['comm_s'] / rec['comm_wall_s']:.3f}"},
                    peak_GiB=f"{rec['peak_GiB']:.2f}", **paged,
                    **{f"{k}_launches": v for k, v in rec["launches"].items() if v})
            if kind == "paged":
                for k, v in runs[0]["launches"].items():
                    total[k] = total.get(k, 0) + v
            ref = refs[(L, kind, run["kv"], run["prefix"])]
            say("mesh-paged", leg=dn, one_card_wall_s=f"{ref['wall_s']:.3f}", one_card_ticks=ref["n_ticks"],
                mesh_wall_s=f"{runs[0]['wall_s']:.3f}", rule=rule.replace(" ", "_"), card=smi.replace(" ", "_"))
            if run.get("plant"):
                held = [h for r in ranks for h in r[f"planted-{name}"]]
                caught = mesh_cap(f"{dn}/planted", held, "bf16")
                say("mesh-paged", leg=dn, planted_fault=run["plant"],
                    vs_f32=f"{max(h['vs_f32'] for h in held):.4e}",
                    one_card_vs_f32=f"{max(h['one_card_vs_f32'] for h in held):.4e}",
                    tolerance="fails" if caught else "PASSES")
                if not caught:
                    faults.append(f"{dn}: the logits tolerance passes a planted fault ({run['plant']})")
    mark("legs")
    if faults:
        raise AssertionError("; ".join(faults))
    mesh_paged_server(paths[2])
    mark("server")
    shutil.rmtree(MESH_PAGED_DIR, ignore_errors=True)
    return total


# ---- slice 19: the seq and stage families (ring attention, sp prefill, the seq-sharded decoder, GPipe) ----

LONG_DIR = os.path.join(REPO, "build", "long_context")
LONG_LAYERS = 4  # 7B width, fp32, seed SEED: a full-depth fp32 copy is 27 GB a rank, and the ranks share the card
LONG_RING = (1, 2048, 32, 128)  # (B, T, H, hs) of the ring attention leg
LONG_RING_GQA = 8  # the kv heads of its GQA form
LONG_RING_ATOL = 1e-4
LONG_SP = (2048, 32)  # sp_prefill's segment, then greedy steps from the gathered cache
LONG_DECODER = (2040, 64)  # the decoder leg's prompt and new tokens: the cache crosses row 2048, the second rank's
LONG_SAMPLED = dict(temperature=0.8, top_p=0.9, seed=7, steps=96)
LONG_SAMPLED_PROMPTS = (24, 40)  # the sampled call's two prompts: the first tokens of prompt_tokens()
LONG_PP = dict(M=2, B=4, T=256, n=32)  # two stages of two layers: M microbatches of B rows, then n steps
# launch 2's decoder: seq_len 512, so that the second seq rank's rows (256-511) are reached in 280 + 64
# steps of four ranks (launch 1 crosses row 2048 in 2104 steps of two)
LONG_SHORT_SEQ = 512
LONG_TP = dict(L=2, prompt=280, new=64)
# the planted append, at seq_len 256: the row of position 130 lands on the rank that does not own it
LONG_PLANT = dict(seq_len=256, pos=130)
LONG_CLI_STEPS = 96
LONG_DEADLINE_S = 900.0


class CommClock:
    """Host seconds this process spends in the collectives and hops of the
    parallel families (``dist.all_reduce`` / ``broadcast`` / ``all_gather``,
    a ring hop's issue and wait), the card synchronized before each so that
    queued compute is not counted; patched in on ``with``, out after."""

    def __init__(self):
        self.s = 0.0
        self._undo = []

    def _wrap(self, owner, name: str) -> None:
        import torch

        real = getattr(owner, name)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **k)
            torch.cuda.synchronize()
            self.s += time.perf_counter() - t0
            return out

        setattr(owner, name, timed)
        self._undo.append((owner, name, real))

    def __enter__(self):
        import torch.distributed as dist

        from llama2_tpu_torch.parallel import collective_matmul as cm

        for owner, name in ((dist, "all_reduce"), (dist, "broadcast"), (dist, "all_gather"), (cm._Ring, "issue"),
                            (cm._Ring, "done")):
            self._wrap(owner, name)
        return self

    def __exit__(self, *exc):
        for owner, name, real in reversed(self._undo):
            setattr(owner, name, real)


def long_timed(run) -> tuple:
    """``run()`` under a CommClock: ``(its value, wall s, comm s)``."""
    import torch

    torch.cuda.synchronize()
    with CommClock() as clock:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, clock.s


def held(toks, logits, ref_toks, ref_logits) -> dict:
    """A stream ``toks`` with the logits that chose them against the
    one-card ``ref_toks`` / ``ref_logits`` (a row a position, float32): the
    first parting position, the largest logit distance over the rows both
    computed from the same prefix, and the one-card top-2 margin where they
    part (the margin rule: a parting is allowed only there, where the margin
    is at most twice that distance)."""
    import torch

    n = min(len(toks), len(ref_toks))
    part = next((i for i in range(n) if toks[i] != ref_toks[i]), None if len(toks) == len(ref_toks) else n)
    rows = (n if part is None else min(part + 1, n))
    d = (logits[:rows].float().cpu() - ref_logits[:rows].float().cpu()).abs()
    margin = None
    if part is not None and part < len(ref_logits):
        top = torch.topk(ref_logits[part].float(), 2).values
        margin = float(top[0] - top[1])
    return {"part": part, "generated": len(ref_toks), "dist": float(d.max()) if rows else 0.0, "margin": margin}


def held_faults(name: str, hs: list, atol: float = F32_LOGIT_ATOL, sampled: bool = False) -> list:
    """The fp32 rule over held streams (``held``): logits within ``atol``
    of the one-card logits over the rows computed from the same prefix, then
    tokens equal, or (greedy) parting only where the one-card margin is at
    most twice the largest distance; a sampled parting is held by
    ``sample_rule`` instead. Prints a line; returns the faults."""
    dist = max(h["dist"] for h in hs)
    faults = [f"{name}: logits {dist:.3e} from the one-card path, past {atol}"] if dist > atol else []
    for h in hs:
        if not sampled and h["part"] is not None and (h["margin"] is None or h["margin"] > 2 * dist):
            faults.append(f"{name}: a stream parts where the margin allows no flip: {h}")
    n = sum(h["generated"] for h in hs)
    same = sum(h["generated"] if h["part"] is None else h["part"] for h in hs)
    say("long", leg=name, streams=len(hs), tokens_equal_before_parting=f"{same}/{n}",
        parted=sum(h["part"] is not None for h in hs), logit_max_abs_diff=f"{dist:.4e}", atol=atol,
        held="yes" if not faults else "NO")
    return faults


def greedy_from(params, config, cache, hidden_last, pos: int, n: int) -> tuple:
    """One card, ``backend="torch"``: ``n`` greedy tokens a row from the
    last prefill hidden ``(B, D)``, decoding from ``cache`` at ``pos``;
    returns ``(tokens (B, n), logits (B, n, V))``."""
    import torch

    from llama2_tpu_torch.models.llama import forward, logits_from_hidden

    logits = [logits_from_hidden(params, hidden_last).float()]
    toks = []
    for i in range(n):
        toks.append(torch.argmax(logits[-1], dim=-1))
        if i < n - 1:
            h = forward(params, cache, toks[-1][:, None], pos + i, config, "torch")
            logits.append(logits_from_hidden(params, h[:, -1]).float())
    return torch.stack(toks, dim=1).cpu(), torch.stack(logits, dim=1)


def long_ring(mesh) -> dict:
    """(a) ``ring_attention`` at LONG_RING over ``seq`` (MHA and GQA), fp32,
    against the one-card ``dense_causal_attention``; K1's fp32 output on
    the same rows as a reading; ms a call and the hops' share of three timed
    calls; then one ring hop's chunk dropped on the last rank (planted)."""
    import torch

    from llama2_tpu_torch.ops.cuda.prefill_attention import flash_prefill_attention
    from llama2_tpu_torch.parallel import collective_matmul as cm
    from llama2_tpu_torch.parallel import ring
    from llama2_tpu_torch.parallel.mesh import SEQ_AXIS

    B, T, H, hs = LONG_RING
    S, i = mesh.shape[SEQ_AXIS], mesh.index(SEQ_AXIS)
    rows = slice(i * T // S, (i + 1) * T // S)
    g = torch.Generator(device=mesh.device).manual_seed(SEED + 19)
    out = {}
    for name, KVH in (("mha", H), ("gqa", LONG_RING_GQA)):
        q, k, v = (torch.randn(B, T, n, hs, generator=g, device=mesh.device) for n in (H, KVH, KVH))
        want = ring.dense_causal_attention(q, k, v)[:, rows]
        got = ring.ring_attention(q, k, v, mesh)
        k1 = flash_prefill_attention(q, k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(), 0)[:, rows]
        _, wall, comm = long_timed(lambda: [ring.ring_attention(q, k, v, mesh) for _ in range(3)])
        out[name] = {"err": float((got - want).abs().max()), "k1_err": float((k1 - want).abs().max()),
                     "ms": 1e3 * wall / 3, "share": comm / wall, "finite": bool(torch.isfinite(got).all())}
        if name == "gqa":  # planted: the first hop's chunk dropped on the last rank (the hop itself still made)
            real, dropped = cm._hop, []

            def drop(r, t, staged, overlap=None):
                got = real(r, t, staged, overlap)
                if i == S - 1 and not dropped:
                    dropped.append(1)
                    return t, got[1]
                return got

            cm._hop = drop
            try:
                planted = ring.ring_attention(q, k, v, mesh)
            finally:
                cm._hop = real
            out["planted"] = float((planted - want).abs().max())
    return out


def long_sp(mesh, params, config, model_axis: bool) -> dict:
    """(b) ``sp_prefill`` of a (1, T) segment, then ``cache_from_segments``:
    the rank's hidden rows, its KV rows and the gathered cache against the
    one-card ``forward`` (``backend="torch"``); on rank 0, greedy steps from
    the gathered cache against the one card's from its own prefill."""
    import dataclasses

    import torch

    from llama2_tpu_torch.models.llama import forward, init_cache
    from llama2_tpu_torch.parallel import sp
    from llama2_tpu_torch.parallel.tp import gather

    T, n = LONG_SP
    S, i = mesh.shape[sp.SEQ_AXIS], mesh.index(sp.SEQ_AXIS)
    dev = mesh.device
    cfg = dataclasses.replace(config, seq_len=T + n)
    tokens = torch.randint(0, config.vocab_size, (1, T), generator=torch.Generator().manual_seed(SEED + 7))
    (hidden, k_seg, v_seg), wall, comm = long_timed(lambda: sp.sp_prefill(params, tokens, config, mesh, model_axis))
    cache = sp.cache_from_segments(init_cache(cfg, 1, device=dev), k_seg, v_seg, mesh)
    whole = gather(hidden, mesh.group(sp.SEQ_AXIS), 1)
    ref_cache = init_cache(cfg, 1, device=dev)
    h_ref = forward(params, ref_cache, tokens.to(dev), 0, cfg, "torch")
    rows = slice(i * T // S, (i + 1) * T // S)
    kvh = k_seg.shape[2]
    heads = slice(mesh.index("model") * kvh, (mesh.index("model") + 1) * kvh)
    out = {"ms": 1e3 * wall, "share": comm / wall,
           "hidden_err": float((hidden - h_ref[:, rows]).abs().max()),
           "kv_err": max(float((seg - ref_cache[name][:, :, heads, rows]).abs().max())
                         for name, seg in (("k", k_seg), ("v", v_seg))),
           "gathered_err": max(float((cache[name][:, :, :, :T] - ref_cache[name][:, :, :, :T]).abs().max())
                               for name in ("k", "v")),
           "kv_heads": kvh, "rows": k_seg.shape[3]}
    if mesh.rank == 0:
        toks, logits = greedy_from(params, cfg, cache, whole[:, -1], T, n)
        ref_toks, ref_logits = greedy_from(params, cfg, ref_cache, h_ref[:, -1], T, n)
        out["held"] = [held(toks[0].tolist(), logits[0], ref_toks[0].tolist(), ref_logits[0])]
    return out


def long_decoder(mesh, params, config, prompt: list[int], new: int, ref_backend: str = "torch",
                 sampled: bool = False, plant: bool = False) -> dict:
    """(c) ``SeqShardedDecoder.generate_batch`` (the CLI's path) on a greedy
    prompt: ms a step, the logits of every generated position recorded
    (``step`` wrapped), the rank's cache (rows, bytes) and the rows it
    wrote; on rank 0 the one-card ``Generator`` (``ref_backend``, fp32) on
    the same weights and its teacher-forced logits. With ``sampled``: the
    LONG_SAMPLED call over two prompts, timed with the merges' share,
    against the ``Generator`` at seed 7 and 8. With ``plant``: a
    teacher-forced run at LONG_PLANT's seq_len whose row of LONG_PLANT's
    position lands on the rank that does not own it, its logits against the
    one card's."""
    import dataclasses

    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.parallel import ring_decode
    from llama2_tpu_torch.runtime.generator import Generator

    dec = ring_decode.SeqShardedDecoder(config, params, mesh)
    caches, recorded = [], []
    real_cache, real_step = dec._cache, dec.step
    dec._cache = lambda b: caches.append(real_cache(b)) or caches[-1]

    def step(cache, token, pos):
        logits = real_step(cache, token, pos)
        if pos >= len(prompt):
            recorded.append(logits[0])
        return logits

    dec.step = step
    steps = len(prompt) + new
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = dec.generate_batch([prompt], GenerationConfig(temperature=0.0, steps=steps))[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kc = caches[0][0]
    # the one card's cache of the same kv heads: seq_len rows, float32, K and V
    whole = 2 * config.n_layers * (config.n_kv_heads // mesh.tp) * config.seq_len * config.head_size * 4
    out = {"tokens": toks, "ms": 1e3 * wall / steps, "steps": steps, "cache_shape": tuple(kc.shape),
           "cache_bytes": 2 * kc.numel() * kc.element_size(), "one_card_cache_bytes": whole,
           "rows_written": int((kc[0, 0, 0].abs().sum(-1) != 0).sum()), "s_local": dec.s_local}
    if mesh.rank == 0:
        g = Generator(config, params, backend=ref_backend, device=mesh.device)
        ref = g.generate(prompt, GenerationConfig(temperature=0.0, steps=steps)).tokens
        ref_logits = teacher_forced_logits(g.params, config, [1] + ref, len(prompt), ref_backend)
        out["held"] = [held(toks[len(prompt):], torch.stack(recorded), ref[len(prompt):], ref_logits[:new])]
    if sampled:
        out["sampled"] = long_sampled(dec, real_step, mesh, params, config)
    if plant:
        out["planted"] = long_planted_append(mesh, params, dataclasses.replace(config, seq_len=LONG_PLANT["seq_len"]))
    return out


def long_sampled(dec, real_step, mesh, params, config) -> dict:
    """The sampled call of (c): ``generate_batch`` over two prompts with
    LONG_SAMPLED (t 0.8, top-p 0.9, seed 7; row ``b`` draws with seed 7 +
    b), timed with the merges' share, every row's logits recorded. On rank
    0, each row against the one-card ``Generator`` at seed 7 + b: the
    sampled tokens equal, or, where they part, the fp32 rule over the rows
    before it and both tokens the sampler's choice on their own logits with
    the one draw (``held`` + ``sample_rule``)."""
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.runtime.generator import Generator

    prompts = [prompt_tokens()[:n] for n in LONG_SAMPLED_PROMPTS]
    recorded = []

    def step(cache, token, pos):
        logits = real_step(cache, token, pos)
        recorded.append(logits)
        return logits

    dec.step = step
    rows, wall, comm = long_timed(lambda: dec.generate_batch(prompts, GenerationConfig(**LONG_SAMPLED)))
    dec.step = real_step
    out = {"ms": 1e3 * wall / len(recorded), "share": comm / wall, "held": [], "rule": []}
    if mesh.rank != 0:
        return out
    g = Generator(config, params, backend="torch", device=mesh.device)
    for b, p in enumerate(prompts):
        seed = LONG_SAMPLED["seed"] + b
        want = g.generate(p, GenerationConfig(**dict(LONG_SAMPLED, seed=seed))).tokens
        n = len(p)
        ref_logits = teacher_forced_logits(g.params, config, [1] + want, n, "torch")
        logits = torch.stack([r[b] for r in recorded[n : n + len(rows[b]) - n]])
        h = held(rows[b][n:], logits, want[n:], ref_logits[: len(want) - n])
        out["held"].append(h)
        if h["part"] is not None:
            out["rule"].append(sample_rule(logits[h["part"]], ref_logits[h["part"]], seed, n + h["part"],
                                           rows[b][n + h["part"]], want[n + h["part"]]))
    return out


def sample_rule(logits, ref_logits, seed: int, pos: int, tok: int, ref_tok: int) -> bool:
    """Where a sampled stream parts from the one card's: both tokens are the
    sampler's choice (LONG_SAMPLED's temperature and top-p, the draw
    ``uniform_draw(seed, pos)``) on their own logits: the parting is the
    logits' difference, nothing else."""
    from llama2_tpu_torch.ops import sampling
    from llama2_tpu_torch.runtime.generator import uniform_draw

    t, p = LONG_SAMPLED["temperature"], LONG_SAMPLED["top_p"]
    mode, r = sampling.choose_mode(t, p), uniform_draw(seed, pos)
    return (int(sampling.sample(logits.float().cpu(), mode, t, p, r)) == tok
            and int(sampling.sample(ref_logits.float().cpu(), mode, t, p, r)) == ref_tok)


def long_planted_append(mesh, params, config) -> float:
    """A decoder at ``config.seq_len`` teacher-forced through position
    LONG_PLANT["pos"] + 8, that position's KV row written on the rank below
    the owner (at its last row) and not on the owner: the largest distance
    of the recorded logits past the fault from the one card's."""
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.parallel import ring_decode
    from llama2_tpu_torch.runtime.generator import Generator

    prompt = [int(t) for t in torch.randint(2, config.vocab_size, (LONG_PLANT["pos"] + 8,),
                                            generator=torch.Generator().manual_seed(SEED + 3))]
    dec = ring_decode.SeqShardedDecoder(config, params, mesh)
    real_append, real_step, recorded = ring_decode._append_local, dec.step, []

    def append(cache, rows, pos, my_off, s_local):
        if pos == LONG_PLANT["pos"]:  # the owner skips it; the rank below writes it at its clamped last row
            owner = pos // s_local
            if my_off == (owner - 1) * s_local:
                cache[:, :, s_local - 1] = rows[:, :, -1]
            return cache
        return real_append(cache, rows, pos, my_off, s_local)

    def step(cache, token, pos):
        logits = real_step(cache, token, pos)
        if pos >= LONG_PLANT["pos"]:
            recorded.append(logits[0])
        return logits

    ring_decode._append_local, dec.step = append, step
    try:
        dec.generate_batch([prompt], GenerationConfig(temperature=0.0, steps=len(prompt)))
    finally:
        ring_decode._append_local = real_append
    if mesh.rank != 0:
        return 0.0
    g = Generator(config, params, backend="torch", device=mesh.device)
    ref = teacher_forced_logits(g.params, config, [1] + prompt, LONG_PLANT["pos"], "torch")
    return float((torch.stack(recorded).cpu() - ref[: len(recorded)]).abs().max())


def long_pp(mesh, params, config, model_axis: bool) -> dict:
    """(d) ``pp_prefill`` of M microbatches over the stages, then
    ``pp_decode`` of their greedy continuation: the hidden and the stage's
    KV rows against the one-card ``forward`` (``backend="torch"``), the
    stage's weight bytes (what ``rank_params`` gave it) against the whole
    stack's; on the last stage (model index 0) the tokens and the
    classifier's logits (recorded) against the one card's greedy loop.
    With ``model_axis`` the prefill alone: ``pp_decode`` has no model axis
    (the JAX one neither), and the prefill's KV is cut over it."""
    import dataclasses

    import torch

    from llama2_tpu_torch.models.llama import forward, init_cache
    from llama2_tpu_torch.ops import sampling
    from llama2_tpu_torch.parallel import pp
    from llama2_tpu_torch.parallel.sp import COLUMN, LAYER_KEYS, ROW

    M, B, T, n = (LONG_PP[k] for k in ("M", "B", "T", "n"))
    S, s = mesh.shape[pp.STAGE_AXIS], mesh.index(pp.STAGE_AXIS)
    dev = mesh.device
    cfg = dataclasses.replace(config, seq_len=T + n)
    tokens = torch.randint(0, config.vocab_size, (M, B, T), generator=torch.Generator().manual_seed(SEED + 5))
    held_bytes, real_rank_params = [], pp.rank_params

    def rank_params(*a, **k):
        local = real_rank_params(*a, **k)
        held_bytes.append(sum(local[key].numel() * local[key].element_size() for key in LAYER_KEYS))
        return local

    pp.rank_params = rank_params
    try:
        (hidden, k_seg, v_seg), wall, comm = long_timed(lambda: pp.pp_prefill(params, tokens, config, mesh,
                                                                              model_axis))
    finally:
        pp.rank_params = real_rank_params
    whole_bytes = sum(params[k].numel() * params[k].element_size() for k in LAYER_KEYS)
    tp = mesh.tp if model_axis else 1
    # a stage's share: 1/S of every layer-stacked weight, the matmul weights 1/tp of that again
    want_bytes = sum(params[k].numel() * params[k].element_size() // S // (tp if k in COLUMN + ROW else 1)
                     for k in LAYER_KEYS)
    out = {"prefill_ms": 1e3 * wall, "prefill_share": comm / wall, "layer_bytes": held_bytes[0],
           "want_layer_bytes": want_bytes, "whole_bytes": whole_bytes, "kv_layers": k_seg.shape[0],
           "want_kv_layers": config.n_layers // S, "hidden_err": 0.0, "kv_err": 0.0}
    layers = slice(s * config.n_layers // S, (s + 1) * config.n_layers // S)
    kvh = k_seg.shape[3]
    heads = slice(mesh.index("model") * kvh, (mesh.index("model") + 1) * kvh)
    refs = []
    for m in range(M):
        ref_cache = init_cache(cfg, B, device=dev)
        h_ref = forward(params, ref_cache, tokens[m].to(dev), 0, cfg, "torch")
        refs.append((ref_cache, h_ref))
        out["hidden_err"] = max(out["hidden_err"], float((hidden[m] - h_ref).abs().max()))
        for name, seg in (("k", k_seg), ("v", v_seg)):
            out["kv_err"] = max(out["kv_err"], float((seg[:, m] - ref_cache[name][layers, :, heads, :T]).abs().max()))
    if model_axis:  # pp_decode has no model axis (as in JAX): the prefill alone
        return out
    wcls = params["wcls"].float()
    tokens0 = torch.argmax(hidden[:, :, -1].float() @ wcls, dim=-1)
    pad = (0, 0, 0, n)
    recorded, real_argmax = [], sampling.sample_argmax
    sampling.sample_argmax = lambda logits: recorded.append(logits) or real_argmax(logits)
    try:
        (got, _, _), wall, comm = long_timed(lambda: pp.pp_decode(
            params, torch.nn.functional.pad(k_seg, pad), torch.nn.functional.pad(v_seg, pad), tokens0,
            torch.full((M, B), T), n, config, mesh))
    finally:
        sampling.sample_argmax = real_argmax
    steps = S * n + S - 1
    out.update(decode_ms=1e3 * wall / steps, decode_steps=steps, decode_share=comm / wall)
    if s == S - 1 and mesh.index("model") == 0:
        out["held"] = []
        for m, (ref_cache, h_ref) in enumerate(refs):
            ref_toks, ref_logits = greedy_from(params, cfg, ref_cache, h_ref[:, -1], T, n)
            logits = torch.stack([recorded[r * S + m] for r in range(n)], dim=1)  # (B, n, V)
            for b in range(B):
                # the continuation's first token is tokens0, chosen from the prefill: pp_decode's stream
                # follows it, the one card's starts with it
                pp_stream = [int(tokens0[m, b])] + got[m, b].tolist()[:-1]
                pp_logits = torch.cat([(hidden[m, b, -1].float() @ wcls)[None], logits[b, :-1]])
                out["held"].append(held(pp_stream, pp_logits, ref_toks[b].tolist(), ref_logits[b]))
    return out


def long_rank(mesh, leg: dict) -> dict:
    """One rank of a launch of ``phase_long_context``: the leg's weights
    (7B width, fp32, ``leg["L"]`` layers, seed SEED) made on the card, the
    same on every rank; then the legs in ``leg["legs"]`` in turn, the
    ``pp`` one over the same ranks viewed as a ``(stage, model)`` mesh.
    Returns numbers, tokens and CPU tensors only."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from llama2_tpu_torch.io.convert import random_params
    from llama2_tpu_torch.parallel import distributed
    from llama2_tpu_torch.parallel.mesh import STAGE_AXIS

    config = config_7b(leg["L"])
    if leg.get("seq_len"):
        config = dataclasses.replace(config, seq_len=leg["seq_len"])
    params = random_params(config, SEED, mesh.device)
    model = mesh.tp > 1
    out = {"rank": mesh.rank, "coord": mesh.coord, "backend": dist.get_backend(),
           "rule": distributed.backend_rule(mesh.size, "cuda")[1]}
    runs = {
        "ring": lambda: long_ring(mesh),
        "sp": lambda: long_sp(mesh, params, config, model),
        "decoder": lambda: long_decoder(mesh, params, config, leg["prompt"], leg["new"],
                                        leg.get("ref_backend", "torch"), leg.get("sampled", False),
                                        leg.get("plant", False)),
        "pp": lambda: long_pp(dataclasses.replace(mesh, axis=STAGE_AXIS), params, config, model),
    }
    for name in leg["legs"]:
        t0 = time.perf_counter()
        out[name] = runs[name]()
        torch.cuda.synchronize()
        if mesh.rank == 0:  # progress, on stderr: a fault in a later leg leaves this one's time
            print(f"[long] rank=0 leg={name} seconds={time.perf_counter() - t0:.1f}", file=sys.stderr, flush=True)
    return out


def long_prompt(n: int, seed: int) -> list[int]:
    """``n`` seeded token ids (2 .. 31999: no BOS inside)."""
    import torch

    return [int(t) for t in torch.randint(2, 32000, (n,), generator=torch.Generator().manual_seed(seed))]


def long_report(name: str, ranks: list, faults: list) -> None:
    """Print a launch's readings and add its faults: every leg's tolerance
    (``held_faults``), the planted faults caught, the ranks' holdings."""
    lead = ranks[0]
    if "ring" in lead:
        for r in ranks:
            for kind in ("mha", "gqa"):
                a = r["ring"][kind]
                say("long", leg=f"{name}/ring/{kind}", rank=r["rank"], ms_a_call=f"{a['ms']:.3f}",
                    hops_share=f"{a['share']:.3f}", max_abs_err=f"{a['err']:.3e}", atol=LONG_RING_ATOL,
                    k1_f32_max_abs_err=f"{a['k1_err']:.3e}")
                if a["err"] > LONG_RING_ATOL or not a["finite"]:
                    faults.append(f"{name}/ring/{kind} rank {r['rank']}: {a['err']:.3e} past {LONG_RING_ATOL}")
        planted = max(r["ring"]["planted"] for r in ranks)
        say("long", leg=f"{name}/ring/planted", fault="one_hop_dropped_on_the_last_rank", max_abs_err=f"{planted:.3e}",
            tolerance="fails" if planted > LONG_RING_ATOL else "PASSES")
        if planted <= LONG_RING_ATOL:
            faults.append(f"{name}: the ring tolerance passes a dropped hop")
    if "sp" in lead:
        for r in ranks:
            a = r["sp"]
            say("long", leg=f"{name}/sp_prefill", rank=r["rank"], coord=f"{r['coord'][0]},{r['coord'][1]}",
                ms_a_call=f"{a['ms']:.3f}", hops_and_reduces_share=f"{a['share']:.3f}",
                hidden_err=f"{a['hidden_err']:.3e}", kv_err=f"{a['kv_err']:.3e}",
                gathered_cache_err=f"{a['gathered_err']:.3e}", kv_heads=a["kv_heads"], rows=a["rows"])
            if max(a["hidden_err"], a["kv_err"], a["gathered_err"]) > F32_LOGIT_ATOL:
                faults.append(f"{name}/sp_prefill rank {r['rank']}: past {F32_LOGIT_ATOL}: {a}")
        faults += held_faults(f"{name}/sp_prefill/decode_from_gathered_cache", lead["sp"]["held"])
    if "decoder" in lead:
        a = lead["decoder"]
        if any(r["decoder"]["tokens"] != a["tokens"] for r in ranks):
            faults.append(f"{name}/decoder: the ranks' streams differ")
        for r in ranks:
            d = r["decoder"]
            say("long", leg=f"{name}/decoder", rank=r["rank"], coord=f"{r['coord'][0]},{r['coord'][1]}",
                ms_a_step=f"{d['ms']:.3f}", steps=d["steps"], cache_shape="x".join(map(str, d["cache_shape"])),
                cache_GiB=f"{d['cache_bytes'] / 2**30:.3f}", one_card_cache_GiB=f"{d['one_card_cache_bytes'] / 2**30:.3f}",
                rows_written=d["rows_written"])
            sp = len({x["coord"][0] for x in ranks})
            if d["cache_shape"][3] != d["s_local"] or d["cache_bytes"] * sp != d["one_card_cache_bytes"]:
                faults.append(f"{name}/decoder rank {r['rank']}: cache {d['cache_shape']}, {d['cache_bytes']} B")
        last = max(ranks, key=lambda x: x["coord"][0])["decoder"]
        if last["rows_written"] == 0:
            faults.append(f"{name}/decoder: the last seq rank wrote no row")
        faults += held_faults(f"{name}/decoder/greedy", a["held"])
        if "sampled" in a:
            s = a["sampled"]
            say("long", leg=f"{name}/decoder/sampled", ms_a_step=f"{s['ms']:.3f}", merges_share=f"{s['share']:.3f}",
                rows_equal_to_generator_at_seed_plus_b=",".join(str(h["part"] is None) for h in s["held"]),
                parted_at=",".join(str(h["part"]) for h in s["held"]), sampler_explains_parting=s["rule"])
            faults += held_faults(f"{name}/decoder/sampled", s["held"], sampled=True)
            if not all(s["rule"]):
                faults.append(f"{name}/decoder/sampled: a parting the sampler's draw does not explain")
        if "planted" in a:
            say("long", leg=f"{name}/decoder/planted", fault="an_append_on_the_rank_that_does_not_own_the_row",
                logit_max_abs_diff=f"{a['planted']:.3e}", tolerance="fails" if a["planted"] > F32_LOGIT_ATOL
                else "PASSES")
            if a["planted"] <= F32_LOGIT_ATOL:
                faults.append(f"{name}: the decoder's tolerance passes a misplaced append")
    if "pp" in lead:
        for r in ranks:
            a = r["pp"]
            decode = {} if "decode_ms" not in a else dict(
                decode_ms_a_step=f"{a['decode_ms']:.3f}", decode_steps=a["decode_steps"],
                decode_hops_share=f"{a['decode_share']:.3f}")
            say("long", leg=f"{name}/pp", rank=r["rank"], coord=f"{r['coord'][0]},{r['coord'][1]}",
                prefill_ms=f"{a['prefill_ms']:.3f}", prefill_hops_share=f"{a['prefill_share']:.3f}", **decode,
                hidden_err=f"{a['hidden_err']:.3e}",
                kv_err=f"{a['kv_err']:.3e}", layer_bytes=a["layer_bytes"], whole_bytes=a["whole_bytes"],
                kv_layers=a["kv_layers"])
            if max(a["hidden_err"], a["kv_err"]) > F32_LOGIT_ATOL:
                faults.append(f"{name}/pp rank {r['rank']}: past {F32_LOGIT_ATOL}: {a['hidden_err']}, {a['kv_err']}")
            if (a["layer_bytes"], a["kv_layers"]) != (a["want_layer_bytes"], a["want_kv_layers"]):
                faults.append(f"{name}/pp rank {r['rank']}: holds {a['layer_bytes']} B of the layer stack and "
                              f"{a['kv_layers']} layers of KV, want {a['want_layer_bytes']} and {a['want_kv_layers']}")
        held_rows = [h for r in ranks for h in r["pp"].get("held", [])]
        if "decode_ms" in lead["pp"]:
            faults += held_faults(f"{name}/pp_decode", held_rows)


def long_cli(path: str, *extra: str) -> tuple[bytes, str, int]:
    """``python -m llama2_tpu_torch`` on ``path`` with ``-t 0 -n
    LONG_CLI_STEPS -i CLI_PROMPT``: (stdout, stderr, exit code)."""
    cmd = [sys.executable, "-m", "llama2_tpu_torch", path, "-t", "0", "-n", str(LONG_CLI_STEPS), "-i", CLI_PROMPT,
           "-z", TOKENIZER_BIN, "-v", *extra]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, timeout=600, cwd=REPO)
    err = r.stderr.decode(errors="replace")
    tps = [line for line in err.splitlines() if "tokens per second" in line]
    say("long", leg="cli", args="_".join(extra) or "none", rc=r.returncode,
        seconds=f"{time.perf_counter() - t0:.1f}", stdout_bytes=len(r.stdout),
        report=tps[0].strip().replace(" ", "_") if tps else "none")
    return r.stdout, err, r.returncode


def cli_in_process(*args: str) -> tuple[bytes, str, int]:
    """``llama2_tpu_torch.cli.main(args)`` in this process, as ``python -m
    llama2_tpu_torch`` runs it: (stdout bytes, stderr, exit code)."""
    import contextlib
    import io

    from llama2_tpu_torch import cli

    out, err = io.BytesIO(), io.StringIO()
    stdout = io.TextIOWrapper(out, write_through=True)
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(err):
        try:
            rc = cli.main(list(args))
        except SystemExit as e:
            rc = e.code
    stdout.flush()
    return out.getvalue(), err.getvalue(), rc


def long_cli_launch(faults: list, device: str = "cuda") -> None:
    """Launch 3 of ``phase_long_context``: the CLI on a param cache of the
    launch-1 weights (``--save-cache``'s format, written here), ``-t 0 -n
    LONG_CLI_STEPS --seq-shards 2 -v`` (a subprocess, as a user runs it)
    printing the plain run's bytes (where they part, the first parting token
    held by the margin rule through a decoder run), logging the shards and
    the backend rule; ``--quant int8 --seq-shards 2`` exits 1 with the JAX
    message. The plain run and the refusal run ``cli.main`` in this process
    (``cli_in_process``): a process start costs seconds."""
    import shutil

    import torch

    from llama2_tpu_torch.io.cache import save_cache
    from llama2_tpu_torch.io.convert import random_params
    from llama2_tpu_torch.parallel import distributed
    from llama2_tpu_torch.tokenizer.tokenizer import Tokenizer

    shutil.rmtree(LONG_DIR, ignore_errors=True)
    config = config_7b(LONG_LAYERS)
    path = os.path.join(LONG_DIR, f"7b-{LONG_LAYERS}L-f32")
    platform = ("--platform", "cpu") if device == "cpu" else ()
    params = random_params(config, SEED, device)
    save_cache(path, config, params, shared=True)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    plain, _, rc = cli_in_process(path, "-t", "0", "-n", str(LONG_CLI_STEPS), "-i", CLI_PROMPT, "-z", TOKENIZER_BIN,
                                  *platform)
    say("long", leg="cli/plain_in_process", rc=rc, seconds=f"{time.perf_counter() - t0:.1f}", stdout_bytes=len(plain))
    torch.cuda.empty_cache()
    seq, err, rc_seq = long_cli(path, "--seq-shards", "2", *platform)
    if rc or rc_seq or not plain:
        faults.append(f"cli: exit codes {rc}, {rc_seq}:\n{err[-2000:]}")
    elif (f"seq shards: 2 (rows per shard: {config.seq_len // 2})" not in err
          or distributed.backend_rule(2, device)[1] not in err):
        faults.append(f"cli --seq-shards 2: the log lacks the shards or the rule:\n{err[-2000:]}")
    elif seq != plain:
        tok = Tokenizer.from_file(TOKENIZER_BIN, 32000)
        prompt = tok.encode(CLI_PROMPT)
        leg = dict(L=LONG_LAYERS, legs=("decoder",), prompt=prompt, new=LONG_CLI_STEPS - len(prompt),
                   ref_backend="cuda")
        lead = rank_pool(2, device).run(long_rank, 2, 1, leg, axis="seq")[0]
        n = next((i for i, (a, b) in enumerate(zip(seq, plain)) if a != b), min(len(seq), len(plain)))
        say("long", leg="cli/parted", first_differing_byte=n, first_differing_token=lead["decoder"]["held"][0]["part"])
        faults += held_faults("cli/--seq-shards_2_vs_plain", lead["decoder"]["held"])
        if lead["decoder"]["held"][0]["part"] is None:
            faults.append("cli --seq-shards 2: its bytes part from the plain run's where the decoder's tokens do not")
    say("long", leg="cli/--seq-shards_2", bytes_equal_to_plain=seq == plain, stdout_bytes=len(seq))
    _, err, rc = cli_in_process(path, "--quant", "int8", "--seq-shards", "2", *platform)
    refused = rc == 1 and "--quant int8 is not supported on this path" in err
    say("long", leg="cli/--quant_int8_--seq-shards_2", rc=rc, refused_with_the_jax_message=refused)
    if not refused:
        faults.append(f"cli --quant int8 --seq-shards 2: exit {rc}:\n{err[-2000:]}")
    shutil.rmtree(LONG_DIR, ignore_errors=True)


def phase_long_context() -> None:
    """This slice's paths, the last JAX families: ring attention and
    sequence-parallel prefill (``parallel/ring.py``, ``parallel/sp.py``), the
    sequence-sharded decoder (``parallel/ring_decode.py``, the CLI's
    ``--seq-shards``) and GPipe prefill and decode (``parallel/pp.py``), at
    7B width (fp32, random weights of seed SEED, LONG_LAYERS layers, seq_len
    4096), every rank a process on the one card (gloo, the rule and
    ``[ring] gloo: hops staged through the host`` printed). No kernel of
    ``ops/cuda`` is on these paths (the JAX package runs them in XLA): K1
    appears only as a reading beside the ring.

    Launch 1, two ranks: (a) ``ring_attention`` at (1, 2048, 32, 128), MHA
    and GQA, within 1e-4 of the one-card oracle, K1 fp32 beside it, a
    dropped hop planted; (b) ``sp_prefill`` of 2048 tokens, hidden, KV rows
    and the gathered cache within 1e-3 of the one-card ``forward``, then 32
    greedy steps from the gathered cache against the one card's; (c) the
    ``SeqShardedDecoder`` on a 2040-token prompt and 64 new tokens (the
    cache crosses row 2048: the second rank writes rows), against the
    one-card ``Generator`` by the fp32 rule (``held_faults``), each rank's
    cache ``seq_len / 2`` rows and half the one-card bytes, a sampled call
    (two prompts, t 0.8, top-p 0.9, seed 7, 96 steps) equal to the
    ``Generator`` at seed 7 and 8, and a misplaced append planted; (d)
    ``pp_prefill`` over two stages of two layers (M = 2 microbatches of 4
    rows, T = 256), then 32 ``pp_decode`` steps, against the one card, each
    stage holding half the layer stack's bytes and its layers of KV.
    Launch 2, four ranks, 2 layers: the decoder over ``make_sp_tp_mesh(2,
    2)`` (seq_len LONG_SHORT_SEQ, 280 + 64 tokens), ``sp_prefill`` with
    ``model``, ``pp_prefill`` / ``pp_decode`` over ``(stage, model)`` 2x2.
    Launch 3, the CLI (``long_cli_launch``). Every leg is printed before a
    fault fails the phase. Two ranks time-slice one card and hop through the
    host: these times say nothing of a seq or stage axis across cards."""
    from llama2_tpu_torch.parallel import distributed

    smi = nvidia_smi()
    mark = stopwatch("phase_long_context")
    faults: list = []
    rule = distributed.backend_rule(2, "cuda")[1]
    launch1 = dict(L=LONG_LAYERS, legs=("ring", "sp", "decoder", "pp"), prompt=long_prompt(LONG_DECODER[0], SEED + 1),
                   new=LONG_DECODER[1], sampled=True, plant=True)
    ranks = rank_pool(2).run(long_rank, 2, 1, launch1, axis="seq")
    print(rule, flush=True)
    if any(r["rule"] != rule or r["backend"] != "gloo" for r in ranks):
        faults.append(f"launch 1: the ranks' backend {[(r['backend'], r['rule']) for r in ranks]}, want gloo")
    long_report("2", ranks, faults)
    mark("launch1")
    launch2 = dict(L=LONG_TP["L"], seq_len=LONG_SHORT_SEQ, legs=("sp", "decoder", "pp"),
                   prompt=long_prompt(LONG_TP["prompt"], SEED + 2), new=LONG_TP["new"])
    ranks = rank_pool(4).run(long_rank, 2, 2, launch2, axis="seq")
    print(distributed.backend_rule(4, "cuda")[1], flush=True)
    long_report("2x2", ranks, faults)
    mark("launch2")
    long_cli_launch(faults)
    mark("launch3_cli")
    say("long", card=smi.replace(" ", "_"), note="ranks_time_slice_one_card_over_gloo")
    if faults:
        raise AssertionError("; ".join(faults))


def stopwatch(phase: str):
    """``mark(step)``: prints the seconds since the last mark (or since the
    call) on a ``[phase]`` line for ``phase/step``."""
    last = [time.perf_counter()]

    def mark(step: str) -> None:
        now = time.perf_counter()
        say("phase", name=f"{phase}/{step}", seconds=f"{now - last[0]:.1f}")
        last[0] = now

    return mark


def timed(phase, *args, **kw):
    """``phase(*args, **kw)``, its wall seconds printed on a ``[phase]`` line."""
    t0 = time.perf_counter()
    out = phase(*args, **kw)
    label = "/".join([phase.__name__, *(str(a).replace("torch.", "") for a in args)])
    say("phase", name=label, seconds=f"{time.perf_counter() - t0:.1f}")
    return out


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
    if sys.argv[1:] == ["--window-timing"]:
        phase_window_timing(warm_cycles_per_ms())
        print(smi)
        return 0
    if sys.argv[1:] == ["--norm-timing"]:
        phase_norm_timing()
        print(smi)
        return 0
    if sys.argv[1:] == ["--tools"]:
        phase_perplexity()
        phase_tools()
        print(smi)
        return 0
    if sys.argv[1:] == ["--mesh"]:
        # this slice's phases alone: the kernels at the shard shapes too
        for phase in (phase_kernels, phase_kernels_q8, phase_kernels_mlp, phase_kernels_q8kv, phase_kernels_paged):
            timed(phase)
        timed(phase_mesh)
        timed(phase_mesh_paged)
        close_rank_pools()
        mesh_k10_timing(warm_cycles_per_ms(), torch.Generator(device="cuda").manual_seed(SEED + 17))
        print(smi)
        return 0
    if sys.argv[1:] == ["--long-context"]:
        # this slice's phase alone: the seq and stage families
        timed(phase_long_context)
        close_rank_pools()
        print(smi)
        return 0
    if sys.argv[1:] == ["--q8kv-timing"]:
        phase_q8kv_timing(warm_cycles_per_ms())
        print(smi)
        return 0
    for phase in (phase_kernels, phase_kernels_q8, phase_kernels_mlp, phase_kernels_q8kv,
                  phase_kernels_batch8, phase_kernels_paged, phase_kernels_bench):
        timed(phase)
    # slice 5's main path, served: the paged engine over both pools
    # both pools at 4 layers since slice 19 (8 in slices 17-18; the bf16 one at 32 until slice 16): room for
    # the later slices' phases in the script's time
    served = {kv: timed(phase_serve, kv, 4) for kv in (False, True)}
    accurate = {kv: timed(phase_serve_accurate, kv) for kv in (False, True)}
    # engine-level speculation on the served path: the paged bf16 pool and the dense int8 cache
    timed(phase_serve_spec)
    # the fp-cache main path of slice 3, then slice 4's: the int8 cache
    # at 16 layers since slice 17 (32 before): room for its phase in the script's time
    # the two main single-stream routes at 8 layers since slice 19 (16 in slices 17-18, 32 before), profiled
    fast = timed(phase_generate_q8, "two-launch", "cuda", torch.bfloat16, 8, speculative=True, profile=True)
    q8_launches = {
        "fast": fast,
        "int8kv": timed(phase_generate_q8, "int8kv", "cuda", torch.bfloat16, 8, speculative=True,
                        fp_stream=fast["tokens"], profile=True),
        # the route K13 replaces, end to end (8 layers since slice 17, 16 and 32 before)
        "int8kv-two-launch": timed(phase_generate_q8, "int8kv-two-launch", "cuda", torch.bfloat16, 8),
        # fp32 activations keep T = 1 and T = 4 logits close: the spec check
        # covers most positions there
        "int8kv-accurate": timed(phase_generate_q8, "int8kv-accurate", "cuda-accurate", torch.float32, 8,
                                 speculative=True),
        "int8kv-fp": timed(phase_generate_q8, "int8kv-fp", "cuda", torch.bfloat16, 8),
        "fast-f32": timed(phase_generate_q8, "two-launch", "cuda", torch.float32, 8),
        "composed": timed(phase_generate_q8, "composed", "cuda", torch.bfloat16, 8),
        "ffn-only": timed(phase_generate_q8, "ffn-only", "cuda", torch.bfloat16, 2),
        # 8 layers: the perplexity phase runs this route's prefill chunk at 32
        "accurate": timed(phase_generate_q8, "accurate", "cuda-accurate", torch.float32, 8, speculative=True),
        # the 8-row megakernels: the served runs over both pools (K11, K12),
        # the dense engine over the int8 cache (K13)
        "served": {"K12": served[False]["K12"] + served[True]["K12"],
                   "K11": served[False]["K11"] + served[True]["K11"], "K13": served[True]["dense-K13"]},
    }
    launches = {}
    for dtype in (torch.bfloat16, torch.float32):
        launches[dtype] = timed(phase_generate, dtype, 4)  # 4 layers since slice 19 (8 before)
    timed(phase_cli)
    # this slice's path: the INT8 perplexity gate, then the importer, --profile, the tokenizer, --precompile
    ppl = timed(phase_perplexity)
    q8_launches["ppl-fast"], q8_launches["ppl-accurate"] = ppl["fast"], ppl["accurate"]
    timed(phase_tools)
    # slice 17's path: tensor- and data-parallel serving over a (data, model) mesh
    q8_launches["mesh"] = timed(phase_mesh)
    # this slice's path: the paged engine over the mesh, and the ring collective matmul; its
    # launches join the kernels line's counts of K5, K6 (decode rows), K10 (a rank's tick), K17, K18
    mesh_paged = timed(phase_mesh_paged)
    for k in ("K5", "K6"):
        q8_launches["fast"][k] += mesh_paged.get(k, 0)
    q8_launches["mesh"]["K10-no-residual"] += mesh_paged.get("K10-no-residual", 0)
    # this slice's path: ring attention, sp prefill, the seq-sharded decoder and the pipeline (no kernel)
    timed(phase_long_context)
    # the mesh phases' ranks (a pool a world size, started at its first launch) end here
    close_rank_pools()
    t_timing = time.perf_counter()
    kernels = []
    cycles_per_ms = warm_cycles_per_ms()
    for dtype in (torch.bfloat16, torch.float32):
        kernels += phase_timing(dtype, launches[dtype], cycles_per_ms)
    kernels += phase_timing_q8(q8_launches, cycles_per_ms)
    kernels += phase_timing_paged({"K15": accurate[False]["K15"], "K16": accurate[True]["K16"],
                                   "K17": served[False]["K17"] + mesh_paged.get("K17", 0),
                                   "K18": served[True]["K18"] + mesh_paged.get("K18", 0)}, cycles_per_ms)
    # K15's launches on a served path are over an fp32 pool
    kernels += phase_timing_paged({"K15": accurate[False]["K15"]}, cycles_per_ms, tags=("K15",),
                                  dtype=torch.float32)
    bench_rows = phase_timing_bench()
    say("phase", name="timing", seconds=f"{time.perf_counter() - t_timing:.1f}")
    # slice 6's path: the kernel benchmarks' entry point, counted in its own process
    bench_launches = timed(phase_bench, smi)
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
