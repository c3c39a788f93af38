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
   layouts, the INT8 dequant-matmul kernels at the Llama-2-7B projection
   shapes in both modes, the FFN megakernels at the 7B widths and two ragged
   shapes for 1 to 12 rows; the int8-cache attention kernels (K7 windows of
   1, 4 and 16 rows, K8, K9) at the 7B and a GQA layout, and the whole-layer
   kernel (K13) at the 7B widths, against K9 + K12 too, with the cache
   appends bit-equal, and its attention phase alone; the int8-cache
   attention is held to an elementwise bound that faults planted at pos
   4095 (a dropped chunk, a dropped or misweighted split) fail;
3. the main paths: ``Generator.generate`` at full Llama-2-7B width (random
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
   prefill chunk and decode step (per verify trip for speculative decoding),
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
   against ``Generator.generate`` in this process;
5. kernel timing at the main paths' shapes with CUDA events, the calls
   queued behind a device sleep so that the host's launch rate does not set
   the time, beside the bound, the plain version and a library yardstick
   timed here only (the port never calls it):
   ``scaled_dot_product_attention`` for attention, ``torch.matmul`` on the
   pre-dequantized weight for the dequant-matmuls. No one PyTorch call
   computes an FFN megakernel, an int8-cache attention or the whole layer:
   their lines give the route each replaces (the composed route; SDPA on a
   bf16 cache of the same length; K9 + K12) instead.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a checkout
of the repository, it fails before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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
# float32 FMA outside the tensor cores for f32 work (TF32 is off: parity
# mode); the bf16 tensor-core rate for bf16 work
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
GROUP = 64  # INT8 quant group size (llama2.c runq default)
# the dequant-matmul shapes of a Llama-2-7B layer and classifier: (K, N)
Q8_SHAPES = {
    "wqkv": (4096, 12288), "wo": (4096, 4096), "w13": (4096, 22016),
    "w2": (11008, 4096), "wcls": (4096, 32000), "w1": (4096, 11008),
}
# the FFN megakernels' ragged check shapes: (D, HD, Dq, G, scale factor). HD =
# 1376 = 172 * 8 and D = 2176 = 17 * 128 divide over no power-of-two tile.
MLP_RAGGED = ((256, 1376, 384, 8, 2.0), (2176, 256, 2304, 64, 2.0))
PROMPT_TOKENS = 200
GEN_TOKENS = 64


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


def phase_kernels() -> None:
    import torch

    from llama2_tpu_torch.ops.cuda.attention import (
        flash_decode_attention_stacked,
        flash_decode_attention_stacked_plain,
    )
    from llama2_tpu_torch.ops.cuda.prefill_attention import (
        flash_prefill_attention,
        flash_prefill_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = tolerance(dtype)
        for lname, (H, KVH, hs) in LAYOUTS.items():
            k = randn(1, KVH, S, hs, dtype=dtype)
            v = randn(1, KVH, S, hs, dtype=dtype)
            for T in (2, 7, 128, 300):
                q = randn(1, T, H, hs, dtype=dtype)
                for pos0 in (0, 13, 1000):
                    got = flash_prefill_attention(q, k, v, pos0)
                    want = flash_prefill_attention_plain(q, k, v, pos0)
                    torch.cuda.synchronize()
                    err = compare(got, want, dtype)
                    say("K1", dtype=dtype_name(dtype), layout=lname, T=T, pos0=pos0,
                        max_abs_err=f"{err:.3e}", rtol=rtol, atol=atol)
            del k, v
            L = 2
            for pos_list in ([0], [1], [1000], [S - 1], [7, 1000, S - 1]):
                B = len(pos_list)
                kc = randn(L, B, KVH, S, hs, dtype=dtype)
                vc = randn(L, B, KVH, S, hs, dtype=dtype)
                q = randn(B, 1, H, hs, dtype=dtype)
                k_new = randn(B, KVH, 1, hs, dtype=dtype)
                v_new = randn(B, KVH, 1, hs, dtype=dtype)
                pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
                layer = 1
                k_want, v_want = kc.clone(), vc.clone()
                k_plain, v_plain = kc.clone(), vc.clone()
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
                    raise AssertionError(f"K2 cache append wrong at pos={pos_list}")
                say("K2", dtype=dtype_name(dtype), layout=lname, B=B,
                    pos=",".join(map(str, pos_list)), max_abs_err=f"{err:.3e}",
                    rtol=rtol, atol=atol, append="exact")
                del kc, vc, k_want, v_want, k_plain, v_plain


def rope_tables(pos, hs: int):
    """The step's pair-duplicated (B, hs) float32 cos/sin rows for K4."""
    from llama2_tpu_torch.ops import ref

    cos, sin = ref.rope_angles(pos[:, None], hs)
    return (cos[:, 0].repeat_interleave(2, -1).contiguous(),
            sin[:, 0].repeat_interleave(2, -1).contiguous())


def all_layouts(params: dict) -> dict:
    """The unfused tree together with its ``wqkv`` and ``w13`` fusions."""
    from llama2_tpu_torch.models.llama import fuse_layer_params

    return {**params, **fuse_layer_params(params, "torch")}


def phase_kernels_q8() -> None:
    """K4 against its plain version at the three head layouts; K5/K6 against
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
        for lname, (H, KVH, hs) in LAYOUTS.items():
            L, layer = 2, 1
            for pos_list in ([0], [1000], [S - 1], [7, 1000, S - 1]):
                B = len(pos_list)
                kc = randn(L, B, KVH, S, hs, dtype=dtype)
                vc = randn(L, B, KVH, S, hs, dtype=dtype)
                k_plain, v_plain = kc.clone(), vc.clone()
                qkv = randn(B, H + 2 * KVH, hs, dtype=dtype)
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
                    raise AssertionError(f"K4 cache append wrong at pos={pos_list}")
                say("K4", dtype=dtype_name(dtype), layout=lname, B=B,
                    pos=",".join(map(str, pos_list)), max_abs_err=f"{err:.3e}",
                    rtol=rtol, atol=atol, append="exact")
                del kc, vc, k_plain, v_plain

    params = all_layouts(random_q8_params(config_7b(), SEED + 4, "cuda", group_size=GROUP))
    combos = ((0, False, False), (31, True, False), (31, False, True), (0, True, True))
    for dtype in (torch.float32, torch.bfloat16):
        for mode in ("accurate", "fast"):
            for name, (K, N) in Q8_SHAPES.items():
                worst = {}
                for M in (1, 8, 201):
                    x = randn(M, K, dtype=dtype)
                    if name == "wcls":
                        got = quant_matmul(x, params[name], mode=mode)
                        want = quant_matmul_plain(x, params[name], mode=mode)
                        torch.cuda.synchronize()
                        worst[M] = compare(got, want, dtype, q8_tolerance(dtype, mode, False))
                        continue
                    rms_w = 1 + 0.1 * randn(K, dtype=dtype)
                    res = randn(M, N, dtype=dtype)
                    for layer, norm, resid in combos:
                        kw = dict(mode=mode, rms_w=rms_w if norm else None,
                                  residual=res if resid else None)
                        got = quant_matmul_stacked(x, params[name], layer, **kw)
                        want = quant_matmul_stacked_plain(x, params[name], layer, **kw)
                        torch.cuda.synchronize()
                        err = compare(got, want, dtype, q8_tolerance(dtype, mode, norm))
                        worst[M] = max(worst.get(M, 0.0), err)
                say("K5" if name == "wcls" else "K6", dtype=dtype_name(dtype), mode=mode,
                    weight=name, K=K, N=N,
                    max_abs_err_M1_M8_M201=",".join(f"{worst[M]:.3e}" for M in (1, 8, 201)),
                    tol_plain_and_fast_prologue=f"{q8_tolerance(dtype, mode, False)},"
                    f"{q8_tolerance(dtype, mode, True)}".replace(" ", ""))
    # no float atomics: the same launch gives the same bits
    x = randn(1, 4096, dtype=torch.bfloat16)
    a = quant_matmul_stacked(x, params["wo"], 5)
    for _ in range(3):
        if not torch.equal(a, quant_matmul_stacked(x, params["wo"], 5)):
            raise AssertionError("K6 gave different bits on the same inputs")
    del params
    torch.cuda.empty_cache()


def phase_kernels_mlp() -> None:
    """K10, K11, K12 against their plain versions: the 7B widths and the two
    ragged shapes; 1, 4, 8 and 12 rows; fp32 and bf16 activations; layers 0,
    L-2 and L-1 of a stack (K12 reads the next layer's norm and QKV weights,
    clamped at the last); K10 with and without the residual. Every call is one
    launch, and a second run of each gives the same bits."""
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

    def once(wrapper, *args, **kw):
        """Two runs of one call: one launch each, equal bits."""
        n0 = wrapper.launches
        a, b = wrapper(*args, **kw), wrapper(*args, **kw)
        if wrapper.launches != n0 + 2:
            raise AssertionError(f"{wrapper.__name__}: {wrapper.launches - n0} launches for 2 calls")
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

            for M in (1, 4, 8, 12):
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
            say("K10-K12", dtype=dtype_name(dtype), D=D, HD=HD, Dq=Dq, G=G, M="1,4,8,12",
                layers=f"0,{L - 2},{L - 1}", bits="equal_on_rerun",
                tol="rtol=%g,atol=2e-3*max|want|" % mlp_tolerance(dtype, x)[0],
                **{f"{k}_max_abs_err": f"{e:.3e}" for k, (e, _) in worst.items()},
                **{f"{k}_err_over_max": f"{r:.2e}" for k, (_, r) in worst.items()})
        del wo, w1, w3, w2, wqkv
    for mt in (1, 2, 4, 8):
        say("K10-K12", rows_a_thread=mt, cooperative_grid_blocks=mb._grid(mt, torch.cuda.current_device()))
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
            cooperative_grid_blocks=mb._grid(mb.row_tile(1), torch.cuda.current_device(), True),
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
                     "mlp_block_kernel"):
            if f"::{name}<" in e.key or e.key.startswith(name):
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


def long_context_profile(g, config, dn: str, steps: int = 16) -> None:
    """``profile_steps`` of the last ``steps`` decode steps of the context
    (positions seq_len - steps .. seq_len - 1), each a forward, the logits and
    the argmax's host sync, as the Generator's loop runs them, over a cache
    whose earlier rows are filled with random values (int8 rows under scales
    of a N(0, 1) row's size, or N(0, 1) rows)."""
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
    profile_steps(dn, f"pos_{pos0}_to_{config.seq_len - 1}", run)
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
    k1.launches = 0
    k2.launches = 0
    res = g.generate(
        prompt, GenerationConfig(temperature=0.0, steps=len(prompt) + GEN_TOKENS)
    )
    launches = {"K1": k1.launches, "K2": k2.launches}
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
    from llama2_tpu_torch.ops.cuda.prefill_attention import flash_prefill_attention
    from llama2_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_stacked

    return {
        "K1": flash_prefill_attention, "K2": flash_decode_attention_stacked,
        "K4": flash_decode_attention_fused, "K5": quant_matmul, "K6": quant_matmul_stacked,
        "K7": flash_decode_attention_q8, "K8": flash_decode_attention_q8_stacked,
        "K9": flash_decode_attention_q8_fused, "K10": mlp_block_stacked,
        "K11": attn_mlp_block_stacked, "K12": layer_tail_qkv_stacked, "K13": layer_block_stacked,
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
    "int8kv-accurate": (lambda L: {"K6": 4 * L, "K5": 1},
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
    "accurate": (lambda L: {"K6": 4 * L, "K1": L, "K5": 1},
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
    finally:
        for f in (path, q8_path):
            if os.path.exists(f):
                os.remove(f)
        shutil.rmtree(cache_dir, ignore_errors=True)


# ---------------------------------------------------------------- phase 5


def sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per device millisecond."""
    import torch

    cycles = 10**7
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def time_ms(fn, n_iter: int, cycles_per_ms: float, n_warm: int = 3, slack: float = 1.5) -> tuple[float, bool]:
    """Mean device ms per call of ``fn(i)`` over ``n_iter`` calls, after
    ``n_warm`` warm-up calls, and whether the calls were queued ahead.

    One Python call takes tens of microseconds on the host, longer than a
    short kernel runs, so events around calls issued one by one would time
    the host's launch rate. The stream is first held by a device sleep longer
    than the host takes to send the calls (``slack`` times the time a first
    round took): the events then see the calls back to back. A function that
    waits on the device inside (the plain K2 reads ``pos`` on the host) cannot
    be queued ahead, and its time includes the host's gaps; the second value
    says which case it was."""
    import torch

    for i in range(n_warm):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_iter):
        fn(i)
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((slack * issue_ms + 1.0) * cycles_per_ms))
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    queued = not start.query()  # the device had not reached the first call yet
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter, queued


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

    def row(name, src, replaces, n_launch, err, ms, plain_ms, lib_ms, nbytes, flops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dn] * 1e3
        r = {
            "name": f"{name}[{dn}]", "route": "cuda", "source": src,
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
    r = row("flash_prefill_attention", "llama2_tpu_torch/csrc/prefill_attention.cu",
            "llama2_tpu/ops/pallas/prefill_attention.py:157", launches["K1"], err,
            ms, plain_ms, lib_ms,
            esize * (2 * B * T * H * hs + 2 * B * KVH * n * hs), 4 * hs * vis)
    say("time", kernel=r["name"], T=T, pos0=pos0, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{lib_ms:.4f}", bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"],
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
        name = "flash_decode_attention_stacked"
        if p == 256:
            r = row(name, "llama2_tpu_torch/csrc/decode_attention.cu",
                    "llama2_tpu/ops/pallas/attention.py:338", launches["K2"], err,
                    ms, plain_ms, lib_ms, nbytes, 4 * hs * B * H * (p + 1))
            bound, by = r["bound_ms"], r["bound_by"]
        else:  # full context: printed and recorded in PERF.md, not in the line
            bound, by = nbytes / HBM_BYTES_PER_S * 1e3, "bytes"
        say("time", kernel=f"{name}[{dn}]", pos=p, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=by,
            max_abs_err=f"{err:.3e}", queued_kernel_plain_library=f"{qk},{qp},{ql}")
    del kc, vc
    torch.cuda.empty_cache()
    return rows


def phase_timing_q8(launches: dict, cycles_per_ms: float) -> list[dict]:
    """K5/K6 at the 7B shapes, M = 1 (a decode step) and M = 201 (the
    prefill chunk), fast mode on bf16 activations and accurate mode on fp32;
    K10-K12 at M = 1 on bf16 activations; and K4 at pos 256 and 4095. Call i
    reads layer i % 32 of a 32-layer stack, as the decode step does, so
    weights come from device memory.

    Bound: each weight byte, scale and activation once (K*N + 4*(K/G)*N +
    activations) over the memory rate, or 2*M*K*N operations over the peak
    of the mode's product type. The library yardstick is ``torch.matmul`` on
    the weight dequantized ahead of time, in the activation dtype: it reads
    2x (bf16) or 4x (fp32) the kernel's weight bytes and does no dequantizing.
    No one PyTorch call computes an FFN megakernel, so its ``library_ms`` is
    null; its line gives the composed route it replaces (the dequant-matmul
    launches and the plain rmsnorm, swiglu and add between them, as the
    ``w13`` layout runs them) and the sum of the matmul yardsticks instead.
    ``launches``: the Q8 routes' counts, by the names ``main`` gives them.
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
    matmul_ms = {}  # the bf16 matmul yardstick at M = 1, by weight
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
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = 2 * M * K * N / PEAK_FLOPS["bf16" if mode == "fast" else "f32"] * 1e3
                bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
                kname = "quant_matmul_stacked" if stacked else "quant_matmul"
                say("time", kernel=f"{kname}[{dn},{mode}]", weight=name, M=M, K=K, N=N,
                    ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                    library_ms_matmul_on_dequantized=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}",
                    bound_by=by, GB_per_s=f"{nbytes / ms / 1e6:.0f}",
                    TFLOP_per_s=f"{2 * M * K * N / ms / 1e9:.2f}", max_abs_err=f"{err:.3e}",
                    queued_kernel_plain_library=f"{qk},{qp},{ql}")
                if M == 1 and mode == "fast":
                    matmul_ms[name] = lib_ms
                if M == 1 and name in ("wqkv", "wcls"):  # the kernel line's rows: the main path's
                    rows.append({
                        "name": f"{kname}[{dn},{mode},{name},M=1]", "route": "cuda", "source": src,
                        "replaces": "llama2_tpu/ops/pallas/quant_matmul.py:"
                        + ("340" if stacked else "476"),
                        "launches": launches[mode]["K6" if stacked else "K5"],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by, "library_ms": lib_ms,
                    })
            del wd

    # K10-K12: one decode row of bf16 activations
    dtype, dn, esize = torch.bfloat16, "bf16", 2
    D, HD = Q8_SHAPES["w1"]
    Dq = Q8_SHAPES["wqkv"][1]
    eps = 1e-5
    wo, w1, w3, w2, w13, wqkv = (params[k] for k in ("wo", "w1", "w3", "w2", "w13", "wqkv"))
    rms_ffn, rms_att = params["rms_ffn"], params["rms_att"]
    x = torch.randn((1, D), generator=gen, device="cuda").to(dtype)
    att = torch.randn((1, D), generator=gen, device="cuda").to(dtype)

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
    cases = (
        ("K12", "layer_tail_qkv_stacked", 792, launches["fast"]["K12"], weights,
         esize * (5 * D + Dq), ("wo", "w13", "w2", "wqkv"),
         lambda i: mb.layer_tail_qkv_stacked(att, x, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, i % L, eps),
         lambda i: mb.layer_tail_qkv_plain(att, x, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, i % L, eps),
         lambda i: composed(i, True, True)),
        ("K11", "attn_mlp_block_stacked", 463, launches["fast"]["K11"], weights - D * Dq,
         esize * 4 * D, ("wo", "w13", "w2"),
         lambda i: mb.attn_mlp_block_stacked(att, x, wo, rms_ffn[i % L], w1, w3, w2, i % L, eps),
         lambda i: mb.attn_mlp_block_plain(att, x, wo, rms_ffn[i % L], w1, w3, w2, i % L, eps),
         lambda i: composed(i, True, False)),
        ("K10", "mlp_block_stacked", 850, launches["ffn-only"]["K10"], 3 * D * HD,
         esize * 3 * D, ("w13", "w2"),
         lambda i: mb.mlp_block_stacked(x, rms_ffn[i % L], w1, w3, w2, i % L, eps),
         lambda i: mb.mlp_block_plain(x, rms_ffn[i % L], w1, w3, w2, i % L, eps),
         lambda i: composed(i, False, False)),
    )
    for tag, kname, line, n_launch, wbytes, abytes, mats, kern, plain, comp in cases:
        got, want = kern(3), plain(3)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = max(compare(g_, w_, dtype, mlp_tolerance(dtype, w_)) for g_, w_ in zip(got, want))
        ms, qk = time_ms(kern, 128, cycles_per_ms)
        plain_ms, qp = time_ms(plain, 8, cycles_per_ms, n_warm=1)
        # many small ops a call: few enough calls that the launch queue holds them all
        comp_ms, qc = time_ms(comp, 32, cycles_per_ms, slack=3.0)
        nbytes = wbytes + 4 * wbytes // GROUP + abytes  # one f32 scale per 64 values
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * wbytes / PEAK_FLOPS["bf16"] * 1e3  # M = 1: two operations a weight
        bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        say("time", kernel=f"{kname}[{dn},M=1]", tag=tag, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            composed_route_ms=f"{comp_ms:.4f}", library_ms="none_(no_single_call)",
            matmul_on_dequantized_sum_ms=f"{sum(matmul_ms[m] for m in mats):.4f}",
            bound_ms=f"{bound:.4f}", bound_by=by, MB=f"{nbytes / 1e6:.1f}",
            GB_per_s=f"{nbytes / ms / 1e6:.0f}", max_abs_err=f"{err:.3e}",
            queued_kernel_plain_composed=f"{qk},{qp},{qc}")
        rows.append({
            "name": f"{kname}[{dn},M=1]", "route": "cuda",
            "source": "llama2_tpu_torch/csrc/mlp_block.cu",
            "replaces": f"llama2_tpu/ops/pallas/mlp_block.py:{line}", "launches": n_launch,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None,
        })
    kv_launches = {"K7": launches["int8kv"]["spec"]["K7"], "K8": launches["int8kv-accurate"]["K8"],
                   "K9": launches["int8kv-two-launch"]["K9"], "K13": launches["int8kv"]["K13"]}
    rows += phase_timing_q8kv(params, kv_launches, cycles_per_ms)
    del params, wo, w1, w3, w2, w13, wqkv, cases
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
        name = f"flash_decode_attention_fused[{dn}]"
        if p == 256:
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # the port itself: absent outside a checkout of the repository
    import llama2_tpu_torch  # noqa: F401

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say("card", name=name.replace(" ", "_"), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    t_start = time.perf_counter()
    phase_build()
    phase_kernels()
    phase_kernels_q8()
    phase_kernels_mlp()
    phase_kernels_q8kv()
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
    }
    launches = {}
    for dtype in (torch.bfloat16, torch.float32):
        launches[dtype] = phase_generate(dtype, 8)
    phase_cli()
    kernels = []
    cycles_per_ms = sleep_cycles_per_ms()
    say("time", sleep_cycles_per_ms=f"{cycles_per_ms:.0f}")
    for dtype in (torch.bfloat16, torch.float32):
        kernels += phase_timing(dtype, launches[dtype], cycles_per_ms)
    kernels += phase_timing_q8(q8_launches, cycles_per_ms)
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
