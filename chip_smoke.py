#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``llama2_tpu_torch``) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py

Phases, one or more lines each; any failed check raises, so the run exits
non-zero:

1. card and build: the device name, ``nvidia-smi`` name and power limit, and
   the build of every CUDA kernel from ``llama2_tpu_torch/csrc`` (seconds,
   ptxas registers / shared memory / spills);
2. each kernel against its plain PyTorch version on the card, fp32 and bf16,
   at the Llama-2-7B, a GQA and the stories15M head layouts;
3. the main path: ``Generator.generate`` at full Llama-2-7B width (random
   weights from a seed, built on the card), bf16 then fp32, a ~200-token
   prompt and 64 greedy tokens with ``backend="cuda"``; launch counts per
   prefill chunk and decode step; a teacher-forced replay of the same token
   stream through ``backend="torch"`` (the plain versions) compared logit by
   logit; decode tok/s, TTFT and peak memory;
4. the CLI entry point ``python -m llama2_tpu_torch`` on a v0 checkpoint at
   7B width with 2 layers, written from a seed;
5. kernel timing at the main path's shapes with CUDA events, the calls
   queued behind a device sleep so that the host's launch rate does not set
   the time, beside the bound, the plain version and
   ``scaled_dot_product_attention`` (a yardstick timed here only; the port
   never calls it).

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


def compare(got, want, dtype) -> float:
    """Max abs error of ``got`` against ``want``; raises past tolerance."""
    import torch

    rtol, atol = tolerance(dtype)
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

    from llama2_tpu_torch.models.llama import forward, init_cache, logits_from_hidden

    dev = params["wq"].device
    cache = init_cache(config, 1, params["wq"].dtype, dev)
    out = []
    tok = torch.tensor([stream[: n_prompt + 1]], device=dev)
    h = forward(params, cache, tok, 0, config, backend)
    out.append(logits_from_hidden(params, h[:, -1])[0].cpu())
    for p in range(n_prompt + 1, len(stream)):
        tok = torch.tensor([[stream[p]]], device=dev)
        h = forward(params, cache, tok, p, config, backend)
        out.append(logits_from_hidden(params, h[:, -1])[0].cpu())
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
    # the port's decode kernel at positions 0..16, whatever its rank
    for e in kernels:
        if "decode_kernel" in e.key:
            say("profile", dtype=dn, port_kernel="decode_attention", calls=e.count,
                device_us_per_call=f"{e.self_device_time_total / e.count:.2f}")


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


# ---------------------------------------------------------------- phase 4


def phase_cli() -> None:
    import torch

    from llama2_tpu_torch.io.checkpoint import save_checkpoint
    from llama2_tpu_torch.io.convert import random_params

    config = config_7b(n_layers=2)
    params = random_params(config, SEED + 1, "cuda", torch.float32)
    params = {k: v.cpu().numpy() for k, v in params.items() if k != "wcls"}
    path = os.path.join(REPO, "build", "smoke", "llama2_7b_width_2_layers.bin")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        save_checkpoint(path, config, params, shared_weights=True)
        del params
        size = os.path.getsize(path)
        cmd = [
            sys.executable, "-m", "llama2_tpu_torch", path, "-t", "0", "-n", "64",
            "-i", "Once upon a time", "-z", TOKENIZER_BIN, "-v",
        ]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, timeout=600, cwd=REPO)
        secs = time.perf_counter() - t0
    finally:
        if os.path.exists(path):
            os.remove(path)
    err = r.stderr.decode(errors="replace")
    if r.returncode != 0:
        raise AssertionError(f"CLI exited {r.returncode}:\n{err}")
    name = torch.cuda.get_device_name(0)
    tps = [line for line in err.splitlines() if "tokens per second" in line]
    if name not in err or not tps or not r.stdout:
        raise AssertionError(f"CLI output lacks the device name or a tokens/s line:\n{err}")
    say("cli", checkpoint_GB=f"{size / 1e9:.2f}", rc=r.returncode, seconds=f"{secs:.1f}",
        stdout_bytes=len(r.stdout), report=tps[0].strip().replace(" ", "_"))


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
    launches = {}
    for dtype in (torch.bfloat16, torch.float32):
        launches[dtype] = phase_generate(dtype)
    phase_cli()
    kernels = []
    cycles_per_ms = sleep_cycles_per_ms()
    say("time", sleep_cycles_per_ms=f"{cycles_per_ms:.0f}")
    for dtype in (torch.bfloat16, torch.float32):
        kernels += phase_timing(dtype, launches[dtype], cycles_per_ms)
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
