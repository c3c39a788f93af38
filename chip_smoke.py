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
   layouts, the INT8 dequant-matmul kernels at the five Llama-2-7B projection
   shapes in both modes;
3. the main paths: ``Generator.generate`` at full Llama-2-7B width (random
   weights from a seed, built on the card), a ~200-token prompt and 64 greedy
   tokens. INT8 (Q8) weights: ``backend="cuda"`` with bf16 activations, then
   ``backend="cuda-accurate"`` in fp32. bf16 and fp32 weights:
   ``backend="cuda"``. Each with launch counts per prefill chunk and decode
   step, a teacher-forced replay of the same token stream through
   ``backend="torch"`` (the plain versions) compared logit by logit, decode
   tok/s, TTFT and peak memory;
4. the CLI entry point ``python -m llama2_tpu_torch`` on a v0 checkpoint at
   7B width with 2 layers, written from a seed, as it is and with
   ``--quant int8``, and on the ak42 INT8 file converted from it;
5. kernel timing at the main paths' shapes with CUDA events, the calls
   queued behind a device sleep so that the host's launch rate does not set
   the time, beside the bound, the plain version and a library yardstick
   timed here only (the port never calls it):
   ``scaled_dot_product_attention`` for attention, ``torch.matmul`` on the
   pre-dequantized weight for the dequant-matmuls.

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
    "w2": (11008, 4096), "wcls": (4096, 32000),
}
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
    bf16 outputs: one flip of the last bit, as for the attention kernels."""
    import torch

    if dtype != torch.float32:
        return tolerance(dtype)
    return (1e-3, 1e-3) if norm and mode == "fast" else (4e-5, 4e-5)


def compare(got, want, dtype, tol=None) -> float:
    """Max abs error of ``got`` against ``want``; raises past tolerance."""
    import torch

    rtol, atol = tol or tolerance(dtype)
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("kernel output has non-finite values")
    err = (g - w).abs()
    if not bool((err <= atol + rtol * w.abs()).all()):
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


def phase_kernels_q8() -> None:
    """K4 against its plain version at the three head layouts; K5/K6 against
    theirs at the five 7B shapes, M = 1, 8 and 201, both modes, fp32 and bf16
    activations, with and without prologue and epilogue, on layers 0 and 31
    of 32-layer stacks."""
    import torch

    from llama2_tpu_torch.io.convert import random_q8_params
    from llama2_tpu_torch.models.llama import fuse_layer_params
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

    params = fuse_layer_params(random_q8_params(config_7b(), SEED + 4, "cuda", group_size=GROUP))
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


def teacher_forced_logits(params, config, stream: list[int], n_prompt: int, backend: str):
    """Logits of every sampled position of ``stream`` (= [BOS] + prompt +
    generated) through one prefill and T=1 steps, on ``backend``, as float32
    on the host."""
    import torch

    from llama2_tpu_torch.models.llama import (
        activation_dtype,
        forward,
        init_cache,
        logits_from_hidden,
    )

    dev = params["rms_final"].device
    cache = init_cache(config, 1, activation_dtype(params), dev)
    out = []
    tok = torch.tensor([stream[: n_prompt + 1]], device=dev)
    h = forward(params, cache, tok, 0, config, backend)
    out.append(logits_from_hidden(params, h[:, -1], backend)[0].cpu())
    for p in range(n_prompt + 1, len(stream)):
        tok = torch.tensor([[stream[p]]], device=dev)
        h = forward(params, cache, tok, p, config, backend)
        out.append(logits_from_hidden(params, h[:, -1], backend)[0].cpu())
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


def decode_profile(g, dn: str) -> None:
    """Where a decode step's time goes: a torch.profiler trace of 16 greedy
    steps from an empty prompt (its one-token prefill is a decode-kernel
    step too). Prints the device busy share (kernel time summed over the
    wall time of the traced run; tracing adds host time, so it is a lower
    bound) and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llama2_tpu_torch.config import GenerationConfig

    steps = 16
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = g.generate([], GenerationConfig(temperature=0.0, steps=steps))
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # forward steps run: the one-token prefill, one per emitted token, and
    # one more when a BOS ended the loop early
    n = len(res.tokens) + (1 if len(res.tokens) == steps else 2)
    say("profile", dtype=dn, forward_steps=n, wall_ms_per_step=f"{res.total_s * 1e3 / n:.3f}",
        device_ms_per_step=f"{dev_ms / n:.3f}" if kernels else "not_measured",
        device_busy_share=f"{dev_ms / (res.total_s * 1e3):.3f}" if kernels else "not_measured")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        say("profile", dtype=dn, kernel=e.key[:60].replace(" ", "_"), calls=e.count,
            device_ms_per_step=f"{e.self_device_time_total / 1e3 / n:.4f}")
    # the port's own kernels at positions 0..16, whatever their rank
    for e in kernels:
        for name in ("decode_kernel", "decode_fused_kernel", "gemv_kernel"):
            if f"::{name}<" in e.key or e.key.startswith(name):
                say("profile", dtype=dn, port_kernel=name, calls=e.count,
                    device_us_per_call=f"{e.self_device_time_total / e.count:.2f}",
                    device_ms_per_step=f"{e.self_device_time_total / 1e3 / n:.4f}")


def phase_generate(dtype) -> dict:
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io.convert import random_params
    from llama2_tpu_torch.ops.cuda.attention import flash_decode_attention_stacked as k2
    from llama2_tpu_torch.ops.cuda.prefill_attention import flash_prefill_attention as k1
    from llama2_tpu_torch.runtime.generator import BOS, Generator

    config = config_7b()
    dn = dtype_name(dtype)
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
    from llama2_tpu_torch.ops.cuda.prefill_attention import flash_prefill_attention
    from llama2_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_stacked

    return {
        "K1": flash_prefill_attention, "K2": flash_decode_attention_stacked,
        "K4": flash_decode_attention_fused, "K5": quant_matmul, "K6": quant_matmul_stacked,
    }


def phase_generate_q8(backend: str, dtype) -> dict:
    """The INT8-weight main path at full 7B width and depth: generate, count
    launches, replay teacher-forced through the plain path."""
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io.convert import random_q8_params
    from llama2_tpu_torch.quant.q8 import QuantTensor
    from llama2_tpu_torch.runtime.generator import BOS, Generator

    config = config_7b()
    L = config.n_layers
    dn = f"q8/{dtype_name(dtype)}/{backend}"
    t0 = time.perf_counter()
    params = random_q8_params(config, SEED, "cuda", dtype, group_size=GROUP)
    torch.cuda.synchronize()
    say("gen", path=dn, params_built_s=f"{time.perf_counter() - t0:.1f}")
    g = Generator(config, params, dtype=dtype, backend=backend, device="cuda")
    prompt = prompt_tokens()
    g.generate(prompt[:8], GenerationConfig(temperature=0.0, steps=10))  # warm-up

    torch.cuda.reset_peak_memory_stats()
    wrappers = count_launches()
    for w in wrappers.values():
        w.launches = 0
    res = g.generate(
        prompt, GenerationConfig(temperature=0.0, steps=len(prompt) + GEN_TOKENS)
    )
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()

    generated = res.tokens[len(prompt):]
    n_gen = len(generated)
    steps = n_gen + (1 if n_gen < GEN_TOKENS else 0)  # a BOS stop still ran its step
    if res.tokens[: len(prompt)] != prompt or not all(0 <= t < config.vocab_size for t in generated):
        raise AssertionError("generate returned a malformed token stream")
    # one prefill chunk: K6 4/layer, K1 1/layer, K5 once. A decode step: K6
    # 4/layer, K5 once, and K4 (fast, glue-fused) or K2 (accurate) 1/layer.
    fused = backend == "cuda"
    want = {
        "K1": L, "K6": 4 * L * (1 + steps), "K5": 1 + steps,
        "K4": L * steps if fused else 0, "K2": 0 if fused else L * steps,
    }
    if launches != want:
        raise AssertionError(f"{dn}: launches {launches}, want {want} ({steps} decode steps)")
    decode_s = res.total_s - res.ttft_s
    say("gen", path=dn, prompt_tokens=len(prompt), generated=n_gen,
        per_prefill_chunk=f"K6={4 * L},K1={L},K5=1",
        per_decode_step=f"K6={4 * L},K5=1,K4={L if fused else 0},K2={0 if fused else L}",
        **{f"{k}_launches": v for k, v in launches.items()})
    say("gen", path=dn, ttft_ms=f"{res.ttft_s * 1e3:.2f}",
        decode_tok_s=f"{n_gen / decode_s:.2f}",
        reference_protocol_tok_s=f"{res.tokens_per_sec:.2f}",
        peak_mem_GiB=f"{peak / 2**30:.2f}")
    if fused:
        decode_profile(g, dn)

    stream = [BOS] + res.tokens
    lc = teacher_forced_logits(g.params, config, stream, len(prompt), backend)
    # the plain path runs the fused wqkv/w13 layout too
    lt = teacher_forced_logits(g.params, config, stream, len(prompt), "torch")
    if lc.shape != (n_gen + 1, config.vocab_size) or not bool(torch.isfinite(lc).all()):
        raise AssertionError(f"teacher-forced logits malformed: {tuple(lc.shape)}")
    diff = float((lc - lt).abs().max())
    same_greedy = lt[:n_gen].argmax(-1).tolist() == generated
    same_replay = lc[:n_gen].argmax(-1).tolist() == generated
    say("gen", path=dn, logit_max_abs_diff_kernel_vs_plain=f"{diff:.3e}",
        logit_absmax=f"{float(lt.abs().max()):.3f}",
        greedy_tokens_identical=same_greedy, kernel_replay_matches_generate=same_replay)
    if not same_replay:
        raise AssertionError(f"{dn}: the teacher-forced kernel replay disagrees with generate")
    if dtype == torch.float32:
        if diff > F32_LOGIT_ATOL or not same_greedy:
            raise AssertionError(
                f"{dn}: kernel vs plain logits differ by {diff} (bound {F32_LOGIT_ATOL}), "
                f"greedy tokens identical: {same_greedy}"
            )
    else:
        ref = {k: v if isinstance(v, QuantTensor) else v.float() for k, v in g.params.items()}
        lr = teacher_forced_logits(ref, config, stream, len(prompt), "torch")
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
    g = params = None
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 4


def run_cli(path: str, *extra: str) -> tuple[bytes, str]:
    """``python -m llama2_tpu_torch`` on ``path``: (stdout, a report line)."""
    import torch

    cmd = [
        sys.executable, "-m", "llama2_tpu_torch", path, "-t", "0", "-n", "64",
        "-i", "Once upon a time", "-z", TOKENIZER_BIN, "-v", *extra,
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
    say("cli", args="_".join(extra) or "none", checkpoint_GB=f"{os.path.getsize(path) / 1e9:.2f}",
        rc=r.returncode, seconds=f"{secs:.1f}", stdout_bytes=len(r.stdout),
        report=tps[0].strip().replace(" ", "_"))
    return r.stdout, err


def phase_cli() -> None:
    """The CLI on a v0 fp32 checkpoint at 7B width with 2 layers; the same
    file quantized on load (``--quant int8``); and the ak42 INT8 file that
    ``python -m llama2_tpu_torch.quant.convert`` writes from it."""
    import torch

    from llama2_tpu_torch.io.checkpoint import save_checkpoint
    from llama2_tpu_torch.io.convert import random_params

    config = config_7b(n_layers=2)
    params = random_params(config, SEED + 1, "cuda", torch.float32)
    params = {k: v.cpu().numpy() for k, v in params.items() if k != "wcls"}
    path = os.path.join(REPO, "build", "smoke", "llama2_7b_width_2_layers.bin")
    q8_path = os.path.join(REPO, "build", "smoke", "llama2_7b_width_2_layers-q8.bin")
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
        _, err = run_cli(q8_path, "--kernels", "cuda", "--dtype", "bf16")
        if "quant: none" not in err:  # the file is INT8 already; no flag needed
            raise AssertionError(f"unexpected CLI log:\n{err}")
    finally:
        for f in (path, q8_path):
            if os.path.exists(f):
                os.remove(f)


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


def time_ms(fn, n_iter: int, cycles_per_ms: float, n_warm: int = 3) -> tuple[float, bool]:
    """Mean device ms per call of ``fn(i)`` over ``n_iter`` calls, after
    ``n_warm`` warm-up calls, and whether the calls were queued ahead.

    One Python call takes tens of microseconds on the host, longer than a
    short kernel runs, so events around calls issued one by one would time
    the host's launch rate. The stream is first held by a device sleep longer
    than the host takes to issue the calls: the events then see the calls
    back to back. A function that waits on the device inside (the plain K2
    reads ``pos`` on the host) cannot be queued ahead, and its time includes
    the host's gaps; the second value says which case it was."""
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
    torch.cuda._sleep(int((1.5 * issue_ms + 1.0) * cycles_per_ms))
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
    """K5/K6 at the five 7B shapes, M = 1 (a decode step) and M = 201 (the
    prefill chunk), fast mode on bf16 activations and accurate mode on fp32,
    and K4 at pos 256 and 4095. Call i reads layer i % 32 of a 32-layer
    stack, as the decode step does, so weights come from device memory.

    Bound: each weight byte, scale and activation once (K*N + 4*(K/G)*N +
    activations) over the memory rate, or 2*M*K*N operations over the peak
    of the mode's product type. The library yardstick is ``torch.matmul`` on
    the weight dequantized ahead of time, in the activation dtype: it reads
    2x (bf16) or 4x (fp32) the kernel's weight bytes and does no dequantizing.
    ``launches``: the main paths' counts, ``{"fast": ..., "accurate": ...}``.
    """
    import torch
    import torch.nn.functional as F

    from llama2_tpu_torch.io.convert import random_q8_params
    from llama2_tpu_torch.models.llama import fuse_layer_params
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
    params = fuse_layer_params(random_q8_params(config_7b(L), SEED + 5, "cuda", group_size=GROUP))
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
                if M == 1 and name in ("w13", "wcls"):  # the kernel line's rows
                    rows.append({
                        "name": f"{kname}[{dn},{mode},{name},M=1]", "route": "cuda", "source": src,
                        "replaces": "llama2_tpu/ops/pallas/quant_matmul.py:"
                        + ("340" if stacked else "476"),
                        "launches": launches[mode]["K6" if stacked else "K5"],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by, "library_ms": lib_ms,
                    })
            del wd
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
    q8_launches = {
        "fast": phase_generate_q8("cuda", torch.bfloat16),
        "accurate": phase_generate_q8("cuda-accurate", torch.float32),
    }
    launches = {}
    for dtype in (torch.bfloat16, torch.float32):
        launches[dtype] = phase_generate(dtype)
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
