"""Generation runtime: prefill, then a decode loop.

Port of ``llama2_tpu/runtime/generator.py`` (the reference's host generation
loop, main.zig:987-1042) for one stream. The prompt is prefilled as one
segment (or ``prefill_chunk``-sized segments); the decode loop is a plain
Python loop of one forward step per token.

Loop semantics match the reference and the JAX package exactly: the
effective sequence is ``[BOS] + prompt + generated``; prompt tokens are
emitted verbatim (teacher forcing); generation stops when the next token is
BOS=1 (EOS id 2 is NOT checked, main.zig:1016-1019); at most ``steps``
tokens are emitted. A BOS inside the prompt stops the loop there, and a
prompt at least ``steps`` long is echoed truncated with no sampling at all.

Randomness: the uniform draw for a sampled position comes from a
``torch.Generator`` seeded from (seed, position), so a stream is a pure
function of the seed. It is not JAX's threefry stream; parity with the JAX
package is defined at temperature 0.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from llama2_tpu_torch.config import GenerationConfig, ModelConfig
from llama2_tpu_torch.models.llama import (
    BACKENDS,
    forward,
    fuse_layer_params,
    init_cache,
    logits_from_hidden,
)
from llama2_tpu_torch.ops import sampling
from llama2_tpu_torch.quant.q8 import QuantTensor

BOS = 1


@dataclasses.dataclass
class GenerateResult:
    tokens: list[int]  # emitted tokens (prompt echo + generated), BOS-stop applied
    prompt_len: int
    ttft_s: float  # prefill time, up to the first sampled token's logits
    total_s: float
    tokens_per_sec: float  # reference protocol: (emitted-1)/time-after-first (main.zig:1043-1047)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises: the
    caller must ask for the CPU explicitly."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return device


def uniform_draw(seed: int, pos: int) -> float:
    """The U[0, 1) draw for position ``pos`` of a stream seeded with ``seed``."""
    mixed = np.random.SeedSequence([seed % 2**64, pos]).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(mixed))
    return float(torch.rand((), generator=gen))


class Generator:
    """One model's prefill and decode loop; the host API for the CLI.

    ``params``: numpy arrays or tensors in the layout of ``io/checkpoint.py``,
    moved to ``device`` as ``dtype`` (tensors already there are not copied).
    Matmul weights may be QuantTensors (INT8 values, float32 scales, both
    kept as they are): ``dtype`` is then the dtype of the activations, the
    norm weights and the embedding, and with a CUDA backend the QKV and
    W1/W3 launches are fused once here (``fuse_layer_params``).
    fp32 is the parity mode: on the card it turns TF32 off for the whole
    process, so the fp32 projections are full-precision products like the
    JAX package's ``Precision.HIGHEST``.
    """

    def __init__(
        self,
        config: ModelConfig,
        params: dict,
        dtype=torch.float32,
        backend: str = "cuda",
        device=None,
        kv_quant: bool = False,
        speculative: int = 0,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
        if kv_quant:
            raise NotImplementedError("the int8 KV cache is not yet ported to the torch package")
        if speculative >= 2:
            raise NotImplementedError(
                "speculative decoding is not yet ported to the torch package"
            )
        self.config = config
        self.dtype = dtype
        self.backend = backend
        self.device = resolve_device(device)
        if dtype == torch.float32 and self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        self.params = {
            k: v.to(self.device)
            if isinstance(v, QuantTensor)
            else torch.as_tensor(v).to(self.device, dtype)
            for k, v in params.items()
        }
        # fuse the QKV and W1/W3 launches on the quantized kernel path
        if backend.startswith("cuda") and isinstance(self.params.get("wq"), QuantTensor):
            self.params = fuse_layer_params(self.params, backend)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _forward(self, cache, tokens, pos: int) -> torch.Tensor:
        """Run a (T,) token segment at ``pos``; returns last-position logits
        (1, 1, V)."""
        tok = torch.as_tensor(np.asarray(tokens, np.int64)[None, :], device=self.device)
        hidden = forward(self.params, cache, tok, pos, self.config, self.backend)
        return logits_from_hidden(self.params, hidden[:, -1:, :], self.backend)

    def _prefill(self, cache, feed: np.ndarray, pos: int, chunk: int) -> torch.Tensor:
        """Prefill ``feed`` at ``pos`` in ``chunk``-token segments."""
        logits = None
        for i in range(0, len(feed), chunk):
            logits = self._forward(cache, feed[i : i + chunk], pos + i)
        return logits

    def generate(
        self,
        prompt_tokens: list[int],
        gen: GenerationConfig,
        prefill_chunk: int | None = None,
    ) -> GenerateResult:
        """The reference generation loop.

        ``prefill_chunk=1`` forces token-at-a-time prefill (the reference's
        exact schedule).
        """
        config = self.config
        steps = gen.resolve_steps(config.seq_len)
        seed = gen.seed if gen.seed is not None else time.time_ns() % (2**63)
        mode = sampling.choose_mode(gen.temperature, gen.top_p)
        top_p = min(max(gen.top_p, 0.0), 1.0)  # clamped like main.zig:899

        # Host-resolved teacher forcing: the echoed prefix is the prompt up to
        # the first BOS (which stops the loop) and at most `steps` tokens.
        prompt = list(prompt_tokens)
        echo = prompt[: prompt.index(BOS)] if BOS in prompt else prompt
        if len(echo) >= steps or len(echo) < len(prompt):
            # Sampling never runs: the loop ends inside the prompt. The
            # reference still runs one forward per emitted token and reports
            # its after-first-token timer (main.zig:1039-1047), so prefill
            # the echoed prefix for real and time it.
            emit = echo[: min(len(echo), steps)]
            t0 = time.perf_counter()
            if not emit:
                return GenerateResult(
                    tokens=[], prompt_len=len(prompt), ttft_s=0.0,
                    total_s=0.0, tokens_per_sec=0.0,
                )
            cache = init_cache(config, 1, self.dtype, self.device)
            feed = np.asarray([BOS] + emit[:-1], dtype=np.int64)
            self._forward(cache, feed[:1], 0)
            self._sync()
            t_first = time.perf_counter()
            if len(feed) > 1:
                self._prefill(cache, feed[1:], 1, prefill_chunk or len(feed) - 1)
            self._sync()
            t1 = time.perf_counter()
            n = len(emit)
            decode_s = t1 - t_first
            return GenerateResult(
                tokens=emit,
                prompt_len=len(prompt),
                ttft_s=t_first - t0,
                total_s=t1 - t0,
                tokens_per_sec=(n - 1) / decode_s if n > 1 and decode_s > 0 else 0.0,
            )

        t0 = time.perf_counter()
        cache = init_cache(config, 1, self.dtype, self.device)
        feed = np.asarray([BOS] + prompt, dtype=np.int64)  # positions 0..P
        logits = self._prefill(cache, feed, 0, prefill_chunk or len(feed))
        self._sync()
        t_prefill = time.perf_counter()

        temperature = gen.temperature if gen.temperature != 0 else 1.0
        generated: list[int] = []
        pos = len(prompt)
        while pos < steps:
            r = None if mode == sampling.ARGMAX else uniform_draw(seed, pos)
            nxt = int(sampling.sample(logits[0, -1], mode, temperature, top_p, r))
            stop = nxt == BOS
            if not stop:
                generated.append(nxt)
            # the forward runs unconditionally, as in the JAX loop: on the
            # last trip its KV row lands past the emitted sequence (clamped to
            # the cache), where no emitted token attends
            logits = self._forward(cache, [nxt], min(pos + 1, config.seq_len - 1))
            pos += 1
            if stop:
                break
        self._sync()
        t1 = time.perf_counter()
        tokens = prompt + generated
        n = len(tokens)
        decode_s = t1 - t_prefill
        return GenerateResult(
            tokens=tokens,
            prompt_len=len(prompt),
            ttft_s=t_prefill - t0,
            total_s=t1 - t0,
            tokens_per_sec=(n - 1) / decode_s if n > 1 and decode_s > 0 else 0.0,
        )
