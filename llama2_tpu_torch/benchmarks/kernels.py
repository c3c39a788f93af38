"""Kernel microbenchmarks of the port: each hand-written CUDA kernel timed
against its plain PyTorch version at fixed shapes.

    python -m llama2_tpu_torch.benchmarks.kernels [SUITE|all] [--iters N] [--platform cpu]

The counterpart of ``benchmarks/kernels.py``, which times the Pallas kernels
against XLA on a TPU and stays as it is. The suites, with that file's shapes
and dtypes (float32 but ``paged``):

* ``rmsnorm``: K19 (``ops/cuda/rmsnorm.py``) at 256 x 4096 and 1024 x 8192;
* ``swiglu``: K20 (``ops/cuda/swiglu.py``) at 256 and 512 rows of 11008;
* ``quant_matmul``: K5 against ``torch.matmul`` on the weight dequantized in
  the call (the JAX "xla dequant+dot" row), M x K x N of 1 x 4096 x 11008,
  8 x 4096 x 11008 and 1 x 4096 x 4096, group 64;
* ``attention``: K3 at B 1, H 32, KVH 4, hs 128, (S, pos) of (2048, 2047),
  (8192, 8191) and (8192, 1023);
* ``attention_stacked``: K2 and K8 (int8 cache) at L 4, B 8, KVH 32, S 2048,
  pos 2040 and 512;
* ``mlp_block``: K10 "fused" against the "split" route (``ref.rmsnorm``, K6
  on ``w13``, ``ref.swiglu``, K6 on ``w2``) at B 8, 4096 x 11008, 2 layers;
* ``prefill``: K1 at T 2048 over S 2048 and 8192;
* ``sample``: ``ops/sampling.py`` at V 32000, draws from a ``torch.Generator``;
* ``paged`` (the JAX file has no such row): K14 and, at the same rows, K15-K18
  at 8 slots, 7B heads (KVH 32, hs 128), bf16, shuffled 256-row pages, pos 256
  and 4095.

Output: a header line (the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them), one line
a (suite, shape, variant): ``name  us/op  GB/s  % of 3.35 TB/s  [TFLOP/s  % of
peak]``, and last a JSON line ``{"launches": {...}}``: each kernel wrapper's
launches over the run, counted from 0 at its start. A plain version is no
yardstick of speed (it repeats the kernel's arithmetic); ``sample`` has no
kernel and prints us/op only.

Bytes are each input read once and each output written once (the JAX file
counted the read side alone for rmsnorm and swiglu); for attention, the K
and V rows of keys 0..pos. Operations are read against the peak of the
activations' dtype (float32 FMA outside the tensor cores: 67 TFLOP/s; bf16:
989). Calls are timed by ``timing.time_ms``: queued behind a device sleep,
between CUDA events; a line marked ``[host gaps]`` could not be queued ahead
(the call waits on the device), and its time includes the host's. Inputs
rotate through copies of at least ``STREAM_BYTES`` in all, call i on copy
i % n, and the last n outputs are kept alive, so that no call finds its
operands in the 50 MB L2.

The suites run on the card; with no card the entry point raises, unless
``--platform cpu`` asks for the CPU, where the wrappers run their plain
versions and the host's clock times them (no share of the card's rates is
printed). Each suite function takes its shapes and ``iters``, so the CPU
tests run them at tiny shapes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

from llama2_tpu_torch.benchmarks import timing
from llama2_tpu_torch.ops import ref, sampling
from llama2_tpu_torch.ops.cuda import attention as fa
from llama2_tpu_torch.ops.cuda import attention_q8 as aq
from llama2_tpu_torch.ops.cuda import mlp_block as mb
from llama2_tpu_torch.ops.cuda import paged_attention as tpa
from llama2_tpu_torch.ops.cuda.prefill_attention import (
    flash_prefill_attention,
    flash_prefill_attention_plain,
)
from llama2_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_stacked
from llama2_tpu_torch.ops.cuda.rmsnorm import rmsnorm, rmsnorm_plain
from llama2_tpu_torch.ops.cuda.swiglu import swiglu, swiglu_plain
from llama2_tpu_torch.quant.q8 import QuantTensor, dequantize, quantize

STREAM_BYTES = 512 * 2**20  # the rotation's least size: ten times the L2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
NAME_WIDTH = 44

# the kernel wrappers the suites launch, by tag; each counts its launches in
# ``.launches``
KERNELS = {
    "K1": flash_prefill_attention,
    "K2": fa.flash_decode_attention_stacked,
    "K3": fa.flash_decode_attention,
    "K5": quant_matmul,
    "K6": quant_matmul_stacked,
    "K8": aq.flash_decode_attention_q8_stacked,
    "K10": mb.mlp_block_stacked,
    "K14": tpa.paged_decode_attention,
    "K15": tpa.paged_decode_attention_stacked,
    "K16": tpa.paged_decode_attention_q8_stacked,
    "K17": tpa.paged_decode_attention_fused,
    "K18": tpa.paged_decode_attention_q8_fused,
    "K19": rmsnorm,
    "K20": swiglu,
}


@dataclasses.dataclass
class Case:
    """One shape of a suite: its variants ``(name, fn(i), is_kernel)``, the
    bytes and operations of one call, the dtype whose peak the operations are
    read against, the copies its inputs rotate over, and the inputs."""

    name: str
    variants: list
    nbytes: int = 0
    flops: int = 0
    dtype: torch.dtype = torch.float32
    copies: int = 1
    inputs: dict = dataclasses.field(default_factory=dict)


class Bench:
    """Where the suites run and how they report. ``iters`` overrides every
    suite's own; ``stream_bytes`` is the rotation's least size."""

    def __init__(self, device="cuda", iters: int | None = None, stream_bytes: int = STREAM_BYTES,
                 seed: int = 0, out=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the kernel benchmarks run on the card "
                               "(--platform cpu runs the plain versions on the host)")
        self.on_card = self.device.type == "cuda"
        self.iters = iters
        self.stream_bytes = stream_bytes
        self.cycles_per_ms = timing.sleep_cycles_per_ms() if self.on_card else None
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.out = out or sys.stdout

    def copies(self, nbytes: int) -> int:
        """How many copies of a call's operands (``nbytes``) make the rotation."""
        return max(1, -(-self.stream_bytes // max(1, nbytes)))

    def randn(self, *shape, dtype=torch.float32) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device).to(dtype)

    def time(self, fn, iters: int, ring: int = 1, kernel: bool = True) -> tuple[float, bool]:
        """ms per call of ``fn(i)`` and whether the calls were queued, the
        last ``ring`` outputs kept alive; a plain version or composed route
        (``kernel=False``) takes an eighth of the calls."""
        n = self.iters or iters
        if not kernel:
            n = max(2, n // 8)
        keep = [None] * ring

        def call(i):
            keep[i % ring] = fn(i)

        return timing.time_ms(call, n, self.cycles_per_ms, n_warm=3 if kernel else 1)

    def run(self, case: Case, iters: int) -> None:
        """Time and report each variant of ``case``."""
        for variant, fn, kernel in case.variants:
            ms, queued = self.time(fn, iters, case.copies, kernel)
            self.report(f"{case.name} {variant}", ms, case.nbytes, case.flops, case.dtype,
                        queued or not self.on_card)

    def report(self, name: str, ms: float, nbytes: int = 0, flops: int = 0,
               dtype=torch.float32, queued: bool = True) -> None:
        line = f"{name:{NAME_WIDTH}s} {ms * 1e3:10.2f} us/op"
        if nbytes:
            gbs = nbytes / ms / 1e6
            line += f"  {gbs:8.1f} GB/s"
            line += f"  {gbs * 1e11 / HBM_BYTES_PER_S:6.1f}% of 3.35 TB/s" if self.on_card else "  (host)"
        if flops:
            tf = flops / ms / 1e9
            line += f"  {tf:8.2f} TFLOP/s"
            if self.on_card:
                peak = PEAK_FLOPS[dtype]
                line += f"  {tf * 1e14 / peak:6.1f}% of {peak / 1e12:.0f} TFLOP/s"
        if not queued:
            line += "  [host gaps]"
        print(line, file=self.out, flush=True)


def _esize(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


# ------------------------------------------------------------------ cases


def rmsnorm_case(b: Bench, R: int, D: int, dtype=torch.float32) -> Case:
    nbytes = 2 * R * D * _esize(dtype) + 4 * D
    n = b.copies(nbytes)
    x = b.randn(n, R, D, dtype=dtype)
    w = 1 + 0.1 * b.randn(D)
    return Case(
        f"rmsnorm[{R}x{D}]",
        [("cuda", lambda i: rmsnorm(x[i % n], w), True),
         ("plain", lambda i: rmsnorm_plain(x[i % n], w), False)],
        nbytes, 0, dtype, n, {"x": x, "w": w},
    )


def swiglu_case(b: Bench, R: int, D: int, dtype=torch.float32) -> Case:
    nbytes = 3 * R * D * _esize(dtype)
    n = b.copies(nbytes)
    h1, h3 = b.randn(n, R, D, dtype=dtype), b.randn(n, R, D, dtype=dtype)
    return Case(
        f"swiglu[{R}x{D}]",
        [("cuda", lambda i: swiglu(h1[i % n], h3[i % n]), True),
         ("plain", lambda i: swiglu_plain(h1[i % n], h3[i % n]), False)],
        nbytes, 0, dtype, n, {"h1": h1, "h3": h3},
    )


def attention_case(b: Bench, S: int, pos: int, B: int = 1, H: int = 32, KVH: int = 4,
                   hs: int = 128, dtype=torch.float32) -> Case:
    """K3: one layer's dense caches, every row at ``pos``. The kernel takes
    the positions as a tensor made ahead; the plain version the int."""
    es = _esize(dtype)
    nbytes = es * (2 * B * KVH * (pos + 1) * hs + 2 * B * H * hs)
    n = b.copies(nbytes)
    q = b.randn(B, 1, H, hs, dtype=dtype)
    k, v = b.randn(n, B, KVH, S, hs, dtype=dtype), b.randn(n, B, KVH, S, hs, dtype=dtype)
    posv = torch.full((B,), pos, dtype=torch.int32, device=b.device)
    return Case(
        f"attn[S{S},pos{pos}]",
        [("cuda", lambda i: fa.flash_decode_attention(q, k[i % n], v[i % n], posv), True),
         ("plain", lambda i: fa.flash_decode_attention_plain(q, k[i % n], v[i % n], pos), False)],
        nbytes, 4 * hs * B * H * (pos + 1), dtype, n, {"q": q, "k": k, "v": v, "pos": posv},
    )


def rope_tables(pos: torch.Tensor, hs: int):
    """The step's pair-duplicated (B, hs) float32 cos/sin rows of the
    glue-fused kernels."""
    cos, sin = ref.rope_angles(pos[:, None], hs)
    return (cos[:, 0].repeat_interleave(2, -1).contiguous(),
            sin[:, 0].repeat_interleave(2, -1).contiguous())


def paged_cases(b: Bench, p: int, B: int = 8, H: int = 32, KVH: int = 32, hs: int = 128,
                page: int = 256, S: int = 4096, dtype=torch.bfloat16) -> list[Case]:
    """K14-K18 with every slot at ``p``: each slot's pages handed out
    shuffled (page 0 is the scratch page), the unused table entries 0. The
    pools hold as many layers as the rotation needs (call i on layer
    i % L): K14 reads layer i % L's pool, K15-K18 append there too."""
    es = _esize(dtype)
    n_used = p // page + 1
    P = B * n_used + 1
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(p)) + 1
    table = torch.zeros((B, S // page), dtype=torch.int32)
    table[:, :n_used] = perm.reshape(B, n_used).to(torch.int32)
    table = table.to(b.device)
    pos = torch.full((B,), p, dtype=torch.int32, device=b.device)
    wpage = table[:, p // page].contiguous()
    wrow = (pos % page).contiguous()
    kv_fp = es * 2 * B * KVH * (p + 1) * hs
    kv_q8 = 2 * B * KVH * (p + 1) * (hs + 4)
    L = b.copies(kv_q8)
    shape = (L, P, KVH, page, hs)
    kp, vp = b.randn(*shape, dtype=dtype), b.randn(*shape, dtype=dtype)

    def int8(shape):
        return torch.randint(-127, 128, shape, generator=b.gen, device=b.device, dtype=torch.int8)

    def scales(shape):
        return 0.02 + 0.01 * torch.rand(shape, generator=b.gen, device=b.device)

    q8 = (int8(shape), scales(shape[:-1]), int8(shape), scales(shape[:-1]))
    q, qkv = b.randn(B, H, hs, dtype=dtype), b.randn(B, H + 2 * KVH, hs, dtype=dtype)
    kn, vn = b.randn(B, KVH, 1, hs, dtype=dtype), b.randn(B, KVH, 1, hs, dtype=dtype)
    k8n, ksn = aq.quantize_kv_rows(kn.float())
    v8n, vsn = aq.quantize_kv_rows(vn.float())
    cos_il, sin_il = rope_tables(pos, hs)
    coords = (wpage, wrow)
    act = es * 2 * B * H * hs  # q in, the output out
    fused_act = es * B * (H + 2 * KVH + H) * hs + 8 * B * hs
    flops = 4 * hs * B * H * (p + 1)
    inputs = {"q": q, "k": kp, "v": vp, "table": table, "pos": pos, "L": L, "n_used": n_used}
    name = f"B{B} page{page},pos{p}"
    return [
        Case(f"paged[K14 {name}]", [
            ("cuda", lambda i: tpa.paged_decode_attention(q, kp[i % L], vp[i % L], table, pos), True),
            ("plain", lambda i: tpa.paged_decode_attention_plain(q, kp[i % L], vp[i % L], table, pos), False),
        ], kv_fp + act, flops, dtype, L, inputs),
        Case(f"paged[K15 {name}]", [
            ("cuda", lambda i: tpa.paged_decode_attention_stacked(
                q, kp, vp, table, kn, vn, *coords, i % L, pos)[0], True),
            ("plain", lambda i: tpa.paged_decode_attention_stacked_plain(
                q, kp, vp, table, kn, vn, *coords, i % L, pos)[0], False),
        ], kv_fp + act + es * 2 * B * KVH * hs, flops, dtype, L),
        Case(f"paged[K16 {name}]", [
            ("cuda", lambda i: tpa.paged_decode_attention_q8_stacked(
                q, *q8, table, k8n, ksn, v8n, vsn, *coords, i % L, pos)[0], True),
            ("plain", lambda i: tpa.paged_decode_attention_q8_stacked_plain(
                q, *q8, table, k8n, ksn, v8n, vsn, *coords, i % L, pos)[0], False),
        ], kv_q8 + act + B * KVH * (2 * hs + 8), flops, dtype, L),
        Case(f"paged[K17 {name}]", [
            ("cuda", lambda i: tpa.paged_decode_attention_fused(
                qkv, kp, vp, table, cos_il, sin_il, *coords, i % L, pos, n_heads=H)[0], True),
            ("plain", lambda i: tpa.paged_decode_attention_fused_plain(
                qkv, kp, vp, table, cos_il, sin_il, *coords, i % L, pos, H)[0], False),
        ], kv_fp + fused_act, flops, dtype, L),
        Case(f"paged[K18 {name}]", [
            ("cuda", lambda i: tpa.paged_decode_attention_q8_fused(
                qkv, *q8, table, cos_il, sin_il, *coords, i % L, pos, n_heads=H)[0], True),
            ("plain", lambda i: tpa.paged_decode_attention_q8_fused_plain(
                qkv, *q8, table, cos_il, sin_il, *coords, i % L, pos, H)[0], False),
        ], kv_q8 + fused_act, flops, dtype, L),
    ]


# ------------------------------------------------------------------ suites


def bench_rmsnorm(b: Bench, shapes=((256, 4096), (1024, 8192)), iters: int = 200) -> None:
    for R, D in shapes:
        b.run(rmsnorm_case(b, R, D), iters)


def bench_swiglu(b: Bench, shapes=((256, 11008), (512, 11008)), iters: int = 200) -> None:
    for R, D in shapes:
        b.run(swiglu_case(b, R, D), iters)


def bench_quant_matmul(b: Bench, shapes=((1, 4096, 11008), (8, 4096, 11008), (1, 4096, 4096)),
                       iters: int = 128, group: int = 64) -> None:
    """Weights from a seeded float32 matrix quantized by ``quant/q8.py``
    (``0.02 N(0, 1)``, as the JAX suite), copied to rotate."""
    rng = np.random.default_rng(0)
    weights = {}
    for M, K, N in shapes:
        nbytes = K * N + 4 * (K // group) * N + 4 * M * (K + N)
        n = b.copies(nbytes)
        if (K, N) not in weights:
            t = quantize(rng.standard_normal((K, N), dtype=np.float32) * 0.02, group)
            stack = (t.q.to(b.device).expand(n, K, N).contiguous(),
                     t.scale.to(b.device).expand(n, K // group, N).contiguous())
            weights[K, N] = QuantTensor(*stack, group)
        w = weights[K, N]
        n = w.q.shape[0]
        x = b.randn(M, K)
        b.run(Case(f"q8matmul[{M}x{K}x{N}]", [
            ("cuda fused", lambda i: quant_matmul(x, w[i % n]), True),
            ("torch dequant+matmul", lambda i: torch.matmul(x, dequantize(w[i % n], x.dtype)), False),
        ], nbytes, 2 * M * K * N, torch.float32, n), iters)


def bench_attention(b: Bench, cases=((2048, 2047), (8192, 8191), (8192, 1023)), B: int = 1,
                    H: int = 32, KVH: int = 4, hs: int = 128, iters: int = 128) -> None:
    for S, pos in cases:
        b.run(attention_case(b, S, pos, B, H, KVH, hs), iters)


def bench_attention_stacked(b: Bench, positions=(2040, 512), L: int = 4, B: int = 8, KVH: int = 32,
                            S: int = 2048, hs: int = 128, iters: int = 48) -> None:
    """The decode path's stacked caches (G = 1, H = KVH), call i on layer
    i % L, the step's rows (zeros) appended in place: K2 over a float32
    cache, K8 over an int8 one."""
    q = b.randn(B, KVH, hs)
    kc, vc = b.randn(L, B, KVH, S, hs), b.randn(L, B, KVH, S, hs)
    kn = torch.zeros((B, KVH, 1, hs), device=b.device)
    for p in positions:
        pos = torch.full((B,), p, dtype=torch.int32, device=b.device)
        b.run(Case(f"attn-stacked[f32 B{B} S{S},pos{p}]", [
            ("cuda", lambda i: fa.flash_decode_attention_stacked(q, kc, vc, kn, kn, i % L, pos), True),
            ("plain", lambda i: fa.flash_decode_attention_stacked_plain(q, kc, vc, kn, kn, i % L, pos), False),
        ], 4 * (2 * B * KVH * (p + 1) * hs + 2 * B * KVH * hs + 4 * B * KVH * hs),
            4 * hs * B * KVH * (p + 1), torch.float32, L), iters)
    del kc, vc
    k8 = torch.randint(-100, 100, (L, B, KVH, S, hs), generator=b.gen, device=b.device, dtype=torch.int8)
    v8 = torch.randint(-100, 100, (L, B, KVH, S, hs), generator=b.gen, device=b.device, dtype=torch.int8)
    ks = 0.01 * torch.rand((L, B, KVH, S), generator=b.gen, device=b.device)
    vs = 0.01 * torch.rand((L, B, KVH, S), generator=b.gen, device=b.device)
    k8n = torch.zeros((B, KVH, 1, hs), dtype=torch.int8, device=b.device)
    ksn = torch.zeros((B, KVH, 1), device=b.device)
    for p in positions:
        pos = torch.full((B,), p, dtype=torch.int32, device=b.device)
        args = (k8, ks, v8, vs, k8n, ksn, k8n, ksn)
        b.run(Case(f"attn-stacked[int8 B{B} S{S},pos{p}]", [
            ("cuda", lambda i: aq.flash_decode_attention_q8_stacked(q, *args, i % L, pos), True),
            ("plain", lambda i: aq.flash_decode_attention_q8_stacked_plain(q, *args, i % L, pos), False),
        ], 2 * B * KVH * (p + 1) * (hs + 4) + 4 * 2 * B * KVH * hs + B * KVH * (2 * hs + 8),
            4 * hs * B * KVH * (p + 1), torch.float32, L), iters)


def bench_mlp_block(b: Bench, L: int = 2, D: int = 4096, HD: int = 11008, B: int = 8,
                    group: int = 64, iters: int = 64) -> None:
    """The FFN megakernel K10 (rmsnorm, w1/w3, swiglu, w2, residual in one
    launch) against the split route it replaces, on 8 float32 rows; int8
    weights uniform under scales ``2.7e-4 U(0.7, 1.3)`` as the JAX suite's,
    call i on layer i % L."""

    def qt(k, n):
        q = torch.randint(-127, 128, (L, k, n), generator=b.gen, device=b.device, dtype=torch.int8)
        s = 2.7e-4 * (0.7 + 0.6 * torch.rand((L, k // group, n), generator=b.gen, device=b.device))
        return QuantTensor(q, s, group)

    w1, w3, w2 = qt(D, HD), qt(D, HD), qt(HD, D)
    w13 = QuantTensor(torch.cat([w1.q, w3.q], -1), torch.cat([w1.scale, w3.scale], -1), group)
    rms_w = 1 + 0.02 * b.randn(D)
    x = b.randn(B, D)
    eps = 1e-5

    def split(i):
        h13 = quant_matmul_stacked(ref.rmsnorm(x, rms_w, eps), w13, i % L)
        return x + quant_matmul_stacked(ref.swiglu(h13[:, :HD], h13[:, HD:]), w2, i % L)

    nbytes = 3 * D * HD + 4 * 3 * D * HD // group + 4 * D + 4 * 2 * B * D
    b.run(Case(f"mlp-block[B{B} {D}x{HD}]", [
        ("fused", lambda i: mb.mlp_block_stacked(x, rms_w, w1, w3, w2, i % L, eps), True),
        ("split", split, False),
    ], nbytes, 2 * B * 3 * D * HD, torch.float32, L), iters)


def bench_prefill(b: Bench, cases=((2048, 2048), (8192, 2048)), B: int = 1, H: int = 32,
                  KVH: int = 4, hs: int = 128, iters: int = 16) -> None:
    """K1 on a T-row segment at position 0: causal, so each query row sees
    its own prefix (2 * 2 * H * hs operations a (query, key) pair)."""
    for S, T in cases:
        nbytes = 4 * (2 * B * T * H * hs + 2 * B * KVH * T * hs)
        n = b.copies(nbytes)
        q = b.randn(n, B, T, H, hs)
        k, v = b.randn(n, B, KVH, S, hs), b.randn(n, B, KVH, S, hs)
        b.run(Case(f"prefill[T{T},S{S}]", [
            ("cuda", lambda i: flash_prefill_attention(q[i % n], k[i % n], v[i % n], 0), True),
            ("plain", lambda i: flash_prefill_attention_plain(q[i % n], k[i % n], v[i % n], 0), False),
        ], nbytes, 4 * H * hs * B * (T * (T + 1) // 2), torch.float32, n), iters)


def bench_sample(b: Bench, V: int = 32000, iters: int = 64) -> None:
    """The samplers on one row of logits; each call draws its uniform from
    an explicit generator on the device. No kernel: us/op only."""
    logits = 3 * b.randn(V)
    draws = torch.Generator(device=b.device).manual_seed(1)

    def r():
        return torch.rand((), generator=draws, device=b.device)

    b.run(Case(f"sample[{V}]", [
        ("argmax", lambda i: sampling.sample_argmax(logits), True),
        ("multinomial", lambda i: sampling.sample_multinomial(
            sampling.probs_from_logits(logits, 1.0), r()), True),
        ("top_p 0.9 (full sort)", lambda i: sampling.sample_top_p(
            sampling.probs_from_logits(logits, 1.0), 0.9, r()), True),
    ]), iters)


def bench_paged(b: Bench, positions=(256, 4095), iters: int = 64, **shape) -> None:
    """K14, and K15-K18 at the same rows (:func:`paged_cases`)."""
    for p in positions:
        for case in paged_cases(b, p, **shape):
            b.run(case, iters)


SUITES = {
    "rmsnorm": bench_rmsnorm,
    "swiglu": bench_swiglu,
    "quant_matmul": bench_quant_matmul,
    "attention": bench_attention,
    "attention_stacked": bench_attention_stacked,
    "mlp_block": bench_mlp_block,
    "prefill": bench_prefill,
    "sample": bench_sample,
    "paged": bench_paged,
}


def header(device: torch.device) -> str:
    """The run's first line: the card as ``nvidia-smi`` names it, with its
    power limit; or the host."""
    if device.type != "cuda":
        return "cpu (host times, no card)"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("suite", nargs="?", default="all", choices=[*SUITES, "all"])
    ap.add_argument("--iters", type=int, default=None, help="calls a kernel is timed over (each suite's own by default)")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    b = Bench(args.platform, iters=args.iters)
    print(header(b.device), flush=True)
    for fn in KERNELS.values():
        fn.launches = 0
    for name in SUITES if args.suite == "all" else [args.suite]:
        SUITES[name](b)
        if b.on_card:
            torch.cuda.empty_cache()
    print(json.dumps({"launches": {tag: fn.launches for tag, fn in KERNELS.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
