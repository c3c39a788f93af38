"""Slot-based continuous batching engine.

Port of ``llama2_tpu/runtime/batch_engine.py``. Decode requests share one
batched KV cache of ``batch_size`` slots; each tick runs ONE decode step for
all slots, every slot at its own position, then new requests are admitted
into freed slots with chunked prefill.

Scheduling (one host thread):
  admit:  pop waiting requests, prefill their prompt into a free slot's
          cache plane (chunks of ``PREFILL_CHUNKS``), echo the prompt per the
          reference's semantics, sample the first token;
  tick:   ``ticks_per_sync`` batched decode steps on the device with the
          per-slot freeze logic there too (a slot freezes when it samples
          BOS, main.zig:1016-1019, or exhausts its budget), then ONE host
          read of the packed ``(n_ticks + 3, B)`` result; with
          ``pipeline_depth`` > 1 the next window is issued before the last
          one is read, its inputs chained from the device;
  retire: a slot frees when its request samples BOS or hits its step limit.

Inactive slots keep decoding at a frozen position; their writes land at
cache positions a later tenant overwrites or never attends, so no masking is
needed.

Sampling: a slot's stream is a function of (seed, position) only, as in the
single-stream ``Generator``: the U[0, 1) draw for position p is
``uniform_draw(seed, p)``, computed on the host for the positions a window
will sample (from the host's projection of each slot's position) and
uploaded with it. The seed is the request's, else a golden-ratio hash of the
engine seed and the admission count. Greedy slots take the argmax; sampled
ones the nucleus sampler (``top_p`` in {0, 1} meaning the whole vocabulary),
row by row. So a seeded stream equals the ``Generator``'s at any
``ticks_per_sync`` and pipeline depth (nucleus mode; the ``Generator``
samples ``top_p`` in {0, 1} by the CDF walk).

Speculative windows (``spec_window`` = d >= 2): while every active slot is
greedy, a tick runs ``ticks_per_sync`` windows instead of steps, each one
(B, d) forward of every slot's last token and d - 1 prompt-lookup drafts
from its own history (:func:`_spec_drafts`), and commits per slot the target
prefix its drafts matched (:func:`_spec_commit`), on the device; then ONE
host read of the packed result, which ``_replay`` applies as a plain tick's.
The streams equal the plain tick's, slot by slot, up to the rounding of a
(B, d) forward against a (B, 1) one. A batch with a sampled slot takes the
plain tick. The dense cache is padded by d rows past ``seq_len`` so a window
from the last position never runs off it.

Cold start (:meth:`BatchEngine.precompile`, the server's ``--precompile``):
each kernel library is built by ``nvcc`` at its first launch and each
kernel's launch plan is worked out at its first shape, so the first request
would pay for both. ``precompile`` builds every library the engine's paths
launch, all at once (:func:`start_kernel_builds` starts them before the
weight upload, so that the two overlap), and runs the prefill chunks of
given prompt lengths, the decode tick and the speculative window once on a
scratch two-layer cache of the engine's shapes, which fills the plans.

Not ported: the mesh (tensor and data parallelism).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from llama2_tpu_torch.config import GenerationConfig, ModelConfig
from llama2_tpu_torch.models.llama import BACKENDS, forward, init_cache, layer_keys, logits_from_hidden
from llama2_tpu_torch.ops import sampling
from llama2_tpu_torch.ops.cuda import attention, attention_q8, build, layer_block, mlp_block, quant_matmul
from llama2_tpu_torch.quant.q8 import QuantTensor
from llama2_tpu_torch.runtime.generator import prepare_params, resolve_device, uniform_draw

BOS = 1

PREFILL_CHUNKS = (128, 32, 8, 1)  # greedy power-of-two-ish decomposition


# the kernels' cached launch plans, by name: what precompile fills
PLAN_CACHES = {
    "attention.plan": attention.plan, "attention_q8.q8_plan": attention_q8.q8_plan,
    "layer_block.launch_plans": layer_block.launch_plans, "mlp_block.launch_plan": mlp_block.launch_plan,
    "quant_matmul.plan": quant_matmul.plan,
}


def plan_entries() -> int:
    """The launch plans cached so far, over :data:`PLAN_CACHES`."""
    return sum(f.cache_info().currsize for f in PLAN_CACHES.values())


def kernel_libraries(params: dict, backend: str, kv_quant: bool) -> list[str]:
    """The kernel libraries (``csrc/<name>.cu``) the dense engine's paths
    launch with these weights, backend and cache kind: the prefill chunks
    (K1 over the fp cache, K7 over the int8 one), the decode tick (K2/K4 or
    K8/K9, the megakernels K10-K13 on ``cuda``) and, with INT8 weights, K5/K6
    in all three and in the speculative window. ``torch`` launches none."""
    if not backend.startswith("cuda"):
        return []
    names = ["attention_q8"] if kv_quant else ["prefill_attention", "decode_attention"]
    if isinstance(params.get("wq", params.get("wqkv")), QuantTensor):
        names.append("quant_matmul")
        if backend == "cuda":
            names.append("mlp_block")
    return names


def start_kernel_builds(params: dict, backend: str, kv_quant: bool) -> None:
    """Start, without waiting, the builds of :func:`kernel_libraries` that
    are missing (one ``nvcc`` each), so that they overlap what the caller
    does next on the card (the engine's weight upload);
    :meth:`BatchEngine.precompile` finishes them."""
    build.start_builds(kernel_libraries(params, backend, kv_quant))


def _chunks(prompt_lens) -> list[int]:
    """The chunk sizes of the PREFILL_CHUNKS decomposition of ``[BOS] +
    prompt`` for each prompt length."""
    chunks: set[int] = set()
    for plen in prompt_lens:
        rem = plen + 1
        while rem:
            c = next(c for c in PREFILL_CHUNKS if rem >= c)
            chunks.add(c)
            rem -= c
    return sorted(chunks)


def _spec_drafts(hist, tokens, pos, d: int, S: int) -> torch.Tensor:
    """Each slot's window input ``[last_token, draft_1..draft_{d-1}]`` (B, d):
    the d - 1 tokens that followed the latest occurrence of the slot's last
    token in its own history ``hist`` (B, S), strictly before position
    ``pos - 1``; where there is none, or the history ends, the token
    repeated (a wrong draft only costs acceptance). As the JAX engine's
    ``_spec_drafts``, on the device."""
    idx = torch.arange(S, device=hist.device)
    match = (hist == tokens[:, None]) & (idx[None, :] < pos[:, None] - 1)
    j = torch.where(match, idx, -1).amax(dim=1)  # (B,)
    at = (j[:, None] + 1 + torch.arange(d - 1, device=hist.device)).clamp(0, S - 1)
    t = hist.gather(1, at)
    drafts = torch.where((j[:, None] >= 0) & (t >= 0), t, tokens[:, None])
    return torch.cat([tokens[:, None], drafts], dim=1)


def _spec_commit(seg, targets, hist, tokens, pos, budget, active, d: int, S: int):
    """Verify a window and commit the accepted prefix of each slot, on the
    device, as the JAX engine's ``_spec_commit``. ``seg`` is the (B, d)
    window input, ``targets`` its (B, d) argmaxes: draft i is verified by
    target i - 1, and the emitted tokens are the target prefix whose drafts
    matched, cut at BOS, at the slot's ``budget`` and where it is not
    ``active``. Returns the new ``(hist, tokens, pos, budget, active)`` and
    ``emitted`` (B, d), -1 where nothing was emitted (BOS itself is emitted,
    so that the host's replay retires the slot)."""
    ok = (seg[:, 1:] == targets[:, :-1]).long()
    acc = 1 + torch.cumprod(ok, dim=1).sum(dim=1)  # (B,)
    emit_idx = torch.arange(d, device=seg.device)[None, :]
    is_bos = targets == BOS
    bos = is_bos.long()
    before_bos = (torch.cumsum(bos, dim=1) - bos) == 0
    accepted = emit_idx < acc[:, None]
    keep = accepted & before_bos & ~is_bos & (emit_idx < budget[:, None]) & active[:, None]
    n_emit = keep.sum(dim=1)
    saw_bos = (accepted & is_bos & active[:, None]).any(dim=1)
    emitted = torch.where(keep, targets, -1)
    emitted = torch.where((emit_idx == n_emit[:, None]) & saw_bos[:, None], BOS, emitted)
    hist = hist.clone()
    slots = torch.arange(hist.shape[0], device=hist.device)
    for k in range(d):  # in order, as the JAX loop writes
        at = (pos + k).clamp(0, S - 1).long()
        hist[slots, at] = torch.where(keep[:, k], targets[:, k], hist[slots, at])
    last = (n_emit - 1).clamp(0, d - 1)
    new_tok = targets.gather(1, last[:, None])[:, 0]
    tokens = torch.where(n_emit > 0, new_tok, tokens)
    pos = torch.where(active, torch.clamp(pos + n_emit, max=S - 1), pos)
    budget = budget - n_emit
    active = active & ~saw_bos & (n_emit == acc) & (budget > 0)
    return hist, tokens, pos, budget, active, emitted


@dataclasses.dataclass
class Request:
    prompt: list[int]
    gen: GenerationConfig
    result_q: "queue.Queue"
    submitted_at: float = dataclasses.field(default_factory=time.perf_counter)
    # filled by the engine:
    tokens: list[int] = dataclasses.field(default_factory=list)
    ttft_s: float | None = None
    admitted_at: float | None = None  # first pulled off the queue (TTFT =
    # queue wait [admitted_at - submitted_at] + prefill [ttft - queue wait])
    steps: int = 0
    retries: int = 0  # engine-recovery re-executions consumed
    sample_seed: int | None = None  # the request's sampling seed, pinned at first admission


@dataclasses.dataclass
class BatchResult:
    tokens: list[int]
    prompt_len: int
    ttft_s: float
    total_s: float
    # TTFT = admission-queue wait + prefill and first-token work, reported
    # apart: under a request wave the p50 TTFT is queueing
    queue_wait_s: float = 0.0
    prefill_s: float = 0.0


class BatchEngine:
    """Continuous batching over a fixed pool of KV-cache slots.

    ``params``: numpy arrays, tensors or QuantTensors (``prepare_params``),
    moved to ``device`` (``None``: the card; the CPU only when asked) as
    ``dtype``; ``backend`` one of ``torch``, ``cuda``, ``cuda-accurate``.
    ``spec_window`` >= 2: greedy speculative windows of that many tokens
    (``ticks_per_sync`` then counts windows); 0 or 1: none.
    """

    _DENSE_CACHE = True  # PagedBatchEngine: pools replace the slot planes

    def __init__(
        self,
        config: ModelConfig,
        params: dict,
        batch_size: int = 8,
        dtype=torch.float32,
        backend: str = "cuda",
        device=None,
        default_seed: int = 0,
        ticks_per_sync: int = 1,
        kv_quant: bool = False,
        max_retries: int = 1,
        pipeline_depth: int = 2,
        spec_window: int = 0,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
        self.config = config
        self.batch_size = batch_size
        self.backend = backend
        self.dtype = dtype
        self.device = resolve_device(device)
        self.params = prepare_params(params, dtype, backend, self.device)
        # how many times an in-flight request is re-executed after an engine
        # failure before its caller gets the error (guards against poison
        # requests)
        self.max_retries = max_retries
        # decode steps a host read: 1 streams with the least latency; more
        # when a sync costs much against a step (tokens then come in bursts)
        self.ticks_per_sync = max(1, ticks_per_sync)
        self.kv_quant = kv_quant
        # greedy speculative windows of spec_window tokens, used while every
        # active slot is greedy; ticks_per_sync then counts windows
        self.spec_window = spec_window if spec_window >= 2 else 0
        # subclasses with their own KV layout (paged) make no dense cache
        self.cache = self._make_cache() if self._DENSE_CACHE else None
        self.waiting: "queue.Queue[Request]" = queue.Queue()
        # requests bounced by admission (paged memory pressure, recovery)
        # retry BEFORE newer arrivals
        self._requeue: list[Request] = []
        self.slots: list[Request | None] = [None] * batch_size
        # host mirrors of device state
        self._tokens = np.zeros(batch_size, np.int32)
        self._pos = np.zeros(batch_size, np.int32)
        # where each slot's position will be once the dispatched windows ran:
        # the positions the next window samples at
        self._pos_ahead = self._pos.copy()
        self._temp = [1.0] * batch_size
        self._topp = [0.9] * batch_size
        self._argmax = np.zeros(batch_size, bool)
        self._seeds = [0] * batch_size
        self.default_seed = default_seed
        self._admit_count = 0  # unseeded requests get a distinct derived seed
        # pipelined sync: dispatched-but-unread packed outputs, and the last
        # window's (tokens, pos, budget, active) device tensors the next
        # window chains from
        self._inflight: list[torch.Tensor] = []
        self._chain: tuple | None = None
        self.pipeline_depth = max(1, pipeline_depth)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.metrics = {
            "requests": 0, "tokens": 0, "ttft": [], "queue_wait": [],
            "prefill": [], "preempted": 0, "spec_windows": 0,
        }

    def _make_cache(self):
        # padded past seq_len by a window, so that a window from the last
        # position never runs off the cache onto committed rows
        return init_cache(self.config, self.batch_size, self.dtype, self.device, self.kv_quant,
                          pad=self.spec_window)

    def _upload(self, a) -> torch.Tensor:
        """A host array as a new device tensor; on the card through pinned
        memory without waiting, so that a pipelined window is issued while
        the last one runs."""
        t = torch.from_numpy(np.array(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ---- public API ----

    def submit(self, prompt_tokens: list[int], gen: GenerationConfig) -> "queue.Queue":
        """Enqueue a request; returns a queue that yields the BatchResult (or
        the exception that ended it)."""
        req = Request(prompt=list(prompt_tokens), gen=gen, result_q=queue.Queue())
        self.waiting.put(req)
        return req.result_q

    def generate(self, prompt_tokens, gen, timeout=600) -> BatchResult:
        res = self.submit(prompt_tokens, gen).get(timeout=timeout)
        if isinstance(res, Exception):
            raise res
        return res

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=30)

    def run_until_idle(self, max_ticks: int = 100_000):
        """Synchronous drive (tests, batch jobs): process the queue to completion."""
        while self._busy() and max_ticks > 0:
            self._step()
            max_ticks -= 1

    # ---- engine internals ----

    def _busy(self) -> bool:
        return bool(not self.waiting.empty() or self._requeue or any(self.slots) or self._inflight)

    def _loop(self):
        while not self._stop.is_set():
            if not self._busy():
                time.sleep(0.001)
                continue
            try:
                self._step()
            except Exception as e:  # noqa: BLE001 -- rebuild and re-queue
                self._recover(e)

    def _recover(self, err: Exception):
        """A failure mid-tick: drop the (possibly poisoned) device state,
        rebuild it, and re-queue the in-flight requests ahead of newer
        arrivals; re-admission teacher-forces each request's emitted stream,
        so it resumes in place. A request that has used its ``max_retries``
        gets the error. The waiting queue held no device state and stays."""
        # count BEFORE delivering any error: a caller woken by result_q.put
        # may read metrics at once
        self.metrics["recoveries"] = self.metrics.get("recoveries", 0) + 1
        survivors = []
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            self.slots[slot] = None
            if req.retries >= self.max_retries:
                req.result_q.put(err)
            else:
                req.retries += 1
                survivors.append(req)
        survivors.extend(self._requeue)
        self._requeue = survivors
        self._inflight = []  # they reference the poisoned state
        self._chain = None
        self._rebuild()

    def _rebuild(self):
        """Recreate all mutable device state after a failure."""
        self.cache = self._make_cache()

    def _fail_all(self, err: Exception):
        self._inflight = []  # references the device state being discarded
        self._chain = None
        for slot, req in enumerate(self.slots):
            if req is not None:
                req.result_q.put(err)
                self.slots[slot] = None
        for req in self._requeue:
            req.result_q.put(err)
        self._requeue.clear()
        while True:
            try:
                req = self.waiting.get_nowait()
            except queue.Empty:
                break
            req.result_q.put(err)
        self._rebuild()

    def _step(self):
        self._admit()
        if any(self.slots):
            self._decode_tick()
        elif self._inflight:
            self._drain(0)

    def _admit(self):
        for slot in range(self.batch_size):
            if self.slots[slot] is not None:
                continue
            if self._requeue:
                req = self._requeue.pop(0)
            else:
                try:
                    req = self.waiting.get_nowait()
                except queue.Empty:
                    return
            self._start_request(slot, req)

    def _feed(self, req: Request):
        """What to prefill for ``req``: ``(resume, steps, feed)``, or None
        when the request finished inside its prompt (delivered here). A
        re-admission (preemption, recovery) replays the emitted stream,
        teacher-forced, so it resumes at the same position."""
        if req.admitted_at is None:  # re-admissions keep the first stamp
            req.admitted_at = time.perf_counter()
        resume = req.ttft_s is not None and len(req.tokens) > len(req.prompt)
        if resume:
            return True, req.steps, np.asarray([BOS] + req.tokens[:-1], dtype=np.int64)
        steps = req.gen.resolve_steps(self.config.seq_len)
        prompt = req.prompt
        echo = prompt[: prompt.index(BOS)] if BOS in prompt else prompt
        if len(echo) >= steps or len(echo) < len(prompt):
            # degenerate: the loop ends inside the prompt (reference semantics)
            req.tokens = echo[: min(len(echo), steps)]
            self._finish(slot_req=req)
            return None
        return False, steps, np.asarray([BOS] + prompt, dtype=np.int64)

    def _prefill(self, cache: dict, feed: np.ndarray, pos: int) -> torch.Tensor:
        """Prefill ``feed`` from ``pos`` into a batch-1 cache in chunks of
        PREFILL_CHUNKS; returns the last position's logits (V,)."""
        logits = None
        remaining = feed
        while len(remaining):
            c = next(c for c in PREFILL_CHUNKS if len(remaining) >= c)
            logits = self._chunk(self.params, self.config, cache, remaining[:c], pos)
            pos += c
            remaining = remaining[c:]
        return logits

    def _chunk(self, params: dict, config: ModelConfig, cache: dict, seg: np.ndarray, pos: int):
        """One prefill chunk ``seg`` at ``pos`` into a batch-1 cache: the
        last position's logits (V,)."""
        seg = torch.as_tensor(seg[None, :], device=self.device)
        if seg.shape[1] == 1 and not all(t.is_contiguous() for t in cache.values()):
            # a one-token chunk runs the decode layer, whose kernels take
            # whole layer-stacked caches: the slot's plane, copied there
            # and back (the JAX engine copies the plane for every chunk)
            plane = {k: t.contiguous() for k, t in cache.items()}
            hidden = forward(params, plane, seg, pos, config, self.backend)
            for k, t in cache.items():
                t.copy_(plane[k])
        else:
            hidden = forward(params, cache, seg, pos, config, self.backend)
        return logits_from_hidden(params, hidden[:, -1, :], self.backend)[0]

    def precompile(self, prompt_lens=(), stochastic=(False,), spec: bool = False) -> int:
        """Pay the cold start before the first request: build (:mod:`build`,
        one ``nvcc`` a source, all at once; those :func:`start_kernel_builds`
        started are waited for) every kernel library the engine's backend,
        weights and cache kind launch, then run, once each, on a scratch
        cache of two layers and the engine's batch, rows and dtype (the
        weights' first two layers; a launch plan does not depend on the
        depth): the prefill chunks of the PREFILL_CHUNKS decomposition of
        ``prompt_lens`` (on slot 0's plane), the decode tick with each
        sampler of ``stochastic`` (greedy, nucleus), and with ``spec`` and
        ``spec_window`` the speculative window. That fills every kernel's
        launch plan for those shapes. Nothing runs on the engine's cache and
        nothing is stored for dispatch. Call it before :meth:`start`.

        Returns the number of libraries built plus the plans filled; 0 on
        the CPU or on ``backend="torch"``, where nothing is built. The paged
        engine raises ``NotImplementedError``."""
        if self.cache is None:
            raise NotImplementedError(
                "precompile covers the dense engine; the paged ticks have their own shapes"
            )
        names = kernel_libraries(self.params, self.backend, self.kv_quant)
        if self.device.type != "cuda" or not names:
            return 0
        built = len(build.build_all(names))
        before = plan_entries()
        L = min(2, self.config.n_layers)
        config = dataclasses.replace(self.config, n_layers=L)
        stacked = set(layer_keys(self.params))
        params = {k: v[:L] if k in stacked else v for k, v in self.params.items()}
        cache = init_cache(config, self.batch_size, self.dtype, self.device, self.kv_quant, pad=self.spec_window)
        plane = {k: v[:, :1] for k, v in cache.items()}
        for c in _chunks(prompt_lens):
            self._chunk(params, config, plane, np.ones(c, np.int64), 0)
        B = self.batch_size
        tokens = self._upload(np.ones(B, np.int32))
        pos = self._upload(np.zeros(B, np.int32))
        for st in stochastic:
            hidden = forward(params, cache, tokens[:, None], pos, config, self.backend)
            logits = logits_from_hidden(params, hidden[:, -1, :], self.backend)
            self._sample(logits, list(range(B)) if st else [], self._upload(np.full(B, 0.5, np.float32)))
        if spec and self.spec_window:
            seg = self._upload(np.ones((B, self.spec_window), np.int64))
            hidden = forward(params, cache, seg, pos.long(), config, self.backend)
            sampling.sample_argmax(logits_from_hidden(params, hidden, self.backend))
        torch.cuda.synchronize(self.device)
        return built + plan_entries() - before

    def _start_request(self, slot: int, req: Request):
        # prefill edits device and host state outside the pipelined chain:
        # flush the windows in flight first
        self._drain(0)
        fed = self._feed(req)
        if fed is None:
            return
        resume, steps, feed = fed
        # the slot's plane of the batched cache, a view: the prefill writes it
        plane = {k: v[:, slot : slot + 1] for k, v in self.cache.items()}
        logits = self._prefill(plane, feed, 0)
        self._admitted(slot, req, resume, steps, len(feed), logits)

    def _admitted(self, slot: int, req: Request, resume: bool, steps: int, pos: int, logits) -> bool:
        """After the prefill of ``pos`` rows: sample the first token, stamp
        TTFT, and seat the request in ``slot``, or finish it. Returns whether
        it holds the slot."""
        if resume:
            first = req.tokens[-1]  # already emitted; its KV row is written next tick
        else:
            first = self._sample_first(logits, req, pos - 1)
        first_admission = req.ttft_s is None  # a re-admission keeps its TTFT
        if first_admission:
            req.ttft_s = time.perf_counter() - req.submitted_at
        if not resume:
            req.tokens = list(req.prompt)
            req.steps = steps
            if first == BOS:
                self._finish(slot_req=req)
                return False
            req.tokens.append(first)  # len(prompt) < steps here (echo check)
        if len(req.tokens) >= steps:
            self._finish(slot_req=req)
            return False
        self.slots[slot] = req
        self._tokens[slot] = first
        self._pos[slot] = pos
        self._seeds[slot] = self._request_seed(req)
        self._temp[slot] = req.gen.temperature if req.gen.temperature > 0 else 1.0
        self._topp[slot] = min(max(req.gen.top_p, 0.0), 1.0)
        self._argmax[slot] = req.gen.temperature == 0.0
        if first_admission:
            self.metrics["requests"] += 1
            self.metrics["ttft"].append(req.ttft_s)
            qw = req.admitted_at - req.submitted_at
            self.metrics["queue_wait"].append(qw)
            self.metrics["prefill"].append(req.ttft_s - qw)
        return True

    def _request_seed(self, req: Request) -> int:
        """The request's sampling seed: its own when given, else a distinct
        one from the engine seed and an admission counter (golden-ratio
        hash, 32 bits as the JAX engine's key holds it). Pinned on the
        request at first admission, so a re-admission resumes the same
        stream."""
        if req.sample_seed is None:
            if req.gen.seed is not None:
                req.sample_seed = req.gen.seed
            else:
                req.sample_seed = (
                    self.default_seed * 0x9E3779B9 + 0x517CC1B7 + self._admit_count
                ) & 0xFFFFFFFF
            self._admit_count += 1
        return req.sample_seed

    def _sample_first(self, logits, req: Request, pos: int) -> int:
        """Sample the first generated token from the prefill's last logits,
        with the draw of position ``pos`` (as the Generator does)."""
        gen = req.gen
        mode = sampling.choose_mode(gen.temperature, gen.top_p)
        r = None if mode == sampling.ARGMAX else uniform_draw(self._request_seed(req), pos)
        temperature = gen.temperature if gen.temperature > 0 else 1.0
        return int(sampling.sample(logits, mode, temperature, min(max(gen.top_p, 0.0), 1.0), r))

    def _host_budget(self) -> np.ndarray:
        return np.asarray(
            [(r.steps - len(r.tokens)) if r is not None else 0 for r in self.slots], np.int32
        )

    def _spec_ready(self) -> bool:
        """Whether this tick runs speculative windows: every active slot
        greedy (a sampled one sends the batch through the plain tick)."""
        active = np.asarray([r is not None for r in self.slots])
        return bool(self.spec_window and active.any() and self._argmax[active].all())

    def _decode_tick(self):
        if self._spec_ready():
            # the windows read the slots' histories from the host and cannot
            # chain on the device: flush the pipeline first (its replays may
            # retire slots)
            self._drain(0)
            if any(self.slots):
                self._spec_tick()
            return
        if self._chain is None:
            self._pos_ahead = self._pos.copy()  # a fresh pipeline: the mirrors are current
        self._dispatch_tick(np.asarray([r is not None for r in self.slots]))
        # pipelined sync: up to depth - 1 windows in flight, so the host read
        # overlaps the next window's device work
        self._drain(self.pipeline_depth - 1)

    def _spec_tick(self):
        """``ticks_per_sync`` speculative windows of every slot on the device,
        then ONE host read of the packed ``(n_windows * d + 3, B)`` result:
        the emitted rows, then tokens, pos and active, which ``_replay``
        applies as it applies a plain tick's."""
        d, S, B = self.spec_window, self.config.seq_len, self.batch_size
        active = np.asarray([r is not None for r in self.slots])
        hist = np.full((B, S), -1, np.int64)
        for slot, req in enumerate(self.slots):
            if req is not None:
                hist[slot, : len(req.tokens)] = req.tokens[:S]
        hist = self._upload(hist)
        tokens = self._upload(self._tokens.astype(np.int64))
        pos = self._upload(self._pos.astype(np.int64))
        budget = self._upload(self._host_budget().astype(np.int64))
        live = self._upload(active)
        emitted = []
        for w in range(self.ticks_per_sync):
            seg = _spec_drafts(hist, tokens, pos, d, S)  # (B, d)
            hidden = self._spec_forward(seg, pos, w)
            targets = sampling.sample_argmax(logits_from_hidden(self.params, hidden, self.backend))
            hist, tokens, pos, budget, live, em = _spec_commit(
                seg, targets.to(seg.dtype), hist, tokens, pos, budget, live, d, S
            )
            emitted.append(em.T)  # (d, B)
        self.metrics["spec_windows"] += self.ticks_per_sync
        packed = torch.cat([*emitted, tokens[None], pos[None], live.long()[None]])
        self._replay(packed.cpu().numpy())
        self._pos_ahead = self._pos.copy()

    def _spec_forward(self, seg, pos, w: int) -> torch.Tensor:
        """Window ``w`` of a speculative tick: the (B, d, D) hidden states of
        every slot's window ``seg`` at its positions ``pos`` (the paged engine
        runs its own)."""
        return forward(self.params, self.cache, seg, pos, self.config, self.backend)

    def _decode_step(self, tokens, pos, i: int) -> torch.Tensor:
        """Step ``i`` of a window: the (B, 1, D) hidden states of one decode
        step of every slot (the paged engine runs its own)."""
        return forward(self.params, self.cache, tokens[:, None], pos, self.config, self.backend)

    def _dispatch_tick(self, active: np.ndarray):
        """Issue one window of ``ticks_per_sync`` decode steps. Inputs chain
        from the previous window's device outputs when one is in flight,
        else come from the host mirrors; the device-side freeze logic makes
        issuing ahead of the host's replay safe (a slot that retired in an
        unread window is frozen on the device and emits -1)."""
        K = self.ticks_per_sync
        S = self.config.seq_len
        if self._chain is not None:
            tokens, pos, budget, chain_active = self._chain
        else:
            tokens = self._upload(self._tokens)
            pos = self._upload(self._pos)
            budget = self._upload(self._host_budget())
            chain_active = self._upload(active)
        sampled = [b for b in range(self.batch_size) if active[b] and not self._argmax[b]]
        draws = None
        if sampled:
            table = np.zeros((K, self.batch_size), np.float32)
            for b in sampled:
                for i in range(K):
                    table[i, b] = uniform_draw(self._seeds[b], min(int(self._pos_ahead[b]) + i, S - 1))
            draws = self._upload(table)

        emitted = []
        for i in range(K):
            hidden = self._decode_step(tokens, pos, i)
            logits = logits_from_hidden(self.params, hidden[:, -1, :], self.backend)
            nxt = self._sample(logits, sampled, None if draws is None else draws[i])
            emitted.append(torch.where(chain_active, nxt, -1))
            # advance active, non-BOS slots; freeze the rest where they stand.
            # The budget (steps - emitted, steps <= seq_len) bounds the walk,
            # so there is no seq_len freeze: cutting at pos + 1 == seq_len
            # would drop a full-length stream's last token
            advance = chain_active & (nxt != BOS)
            budget = torch.where(advance, budget - 1, budget)
            pos = torch.where(advance, torch.clamp(pos + 1, max=S - 1), pos)
            tokens = torch.where(advance, nxt, tokens)
            chain_active = advance & (budget > 0)
        # everything the host reads in ONE tensor: one sync a window
        packed = torch.cat(
            [torch.stack(emitted), tokens[None], pos[None], chain_active.to(torch.int32)[None]]
        )
        self._chain = (tokens, pos, budget, chain_active)
        self._inflight.append(packed)
        self._pos_ahead = np.minimum(self._pos_ahead + K, S - 1)

    def _sample(self, logits, sampled: list[int], draws) -> torch.Tensor:
        """The next token of every slot from its (V,) logits row: the argmax,
        or for the ``sampled`` rows the nucleus sampler with the row's draw
        (``top_p`` in {0, 1} samples the whole vocabulary)."""
        greedy = sampling.sample_argmax(logits)
        if not sampled:
            return greedy
        rows = list(greedy.unbind())
        for b in sampled:
            p = self._topp[b]
            p_eff = 1.0 if p <= 0.0 or p >= 1.0 else p
            probs = sampling.probs_from_logits(logits[b], self._temp[b])
            rows[b] = sampling.sample_top_p(probs, p_eff, draws[b])
        return torch.stack(rows)

    def _drain(self, keep: int = 0):
        """Read and replay in-flight windows until at most ``keep`` remain.
        A full drain also drops the device-side chain, so the next dispatch
        reads the host mirrors (callers flush before any admission, which
        edits state outside the chain)."""
        while len(self._inflight) > keep:
            self._replay(self._inflight.pop(0).cpu().numpy())
        if keep == 0:
            self._chain = None

    def _replay(self, packed: np.ndarray):
        """Apply one window's packed result: emitted rows, then tokens, pos,
        active."""
        emitted = packed[:-3]
        self._tokens = packed[-3].astype(np.int32)
        self._pos = packed[-2].astype(np.int32)
        still_active = packed[-1].astype(bool)
        for t in range(emitted.shape[0]):
            for slot, req in enumerate(self.slots):
                if req is None:
                    continue
                tok = int(emitted[t, slot])
                if tok < 0:  # the slot was frozen on the device this tick
                    continue
                self.metrics["tokens"] += 1
                if tok == BOS:
                    self._finish(slot_req=req, slot=slot)
                    continue
                req.tokens.append(tok)
                if len(req.tokens) >= req.steps:
                    self._finish(slot_req=req, slot=slot)
        # a slot the device froze (its budget spent mid-window) that the
        # replay did not retire would never emit again: retire it now
        for slot, req in enumerate(self.slots):
            if req is not None and not still_active[slot]:
                self._finish(slot_req=req, slot=slot)

    def _finish(self, slot_req: Request, slot: int | None = None):
        if slot is not None:
            self._on_retire(slot)
            self.slots[slot] = None
        admitted = slot_req.admitted_at or slot_req.submitted_at
        ttft = slot_req.ttft_s or 0.0
        slot_req.result_q.put(
            BatchResult(
                tokens=slot_req.tokens,
                prompt_len=len(slot_req.prompt),
                ttft_s=ttft,
                total_s=time.perf_counter() - slot_req.submitted_at,
                queue_wait_s=admitted - slot_req.submitted_at,
                prefill_s=max(0.0, ttft - (admitted - slot_req.submitted_at)),
            )
        )

    def _on_retire(self, slot: int) -> None:
        """Hook for subclasses (the paged engine releases the slot's pages)."""

    # ---- metrics ----

    def ttft_percentiles(self) -> dict:
        def pct(series):
            t = sorted(series)
            if not t:
                return None, None
            return t[len(t) // 2], t[min(len(t) - 1, int(len(t) * 0.95))]

        p50, p95 = pct(self.metrics["ttft"])
        qw50, qw95 = pct(self.metrics["queue_wait"])
        pf50, pf95 = pct(self.metrics["prefill"])
        return {
            "p50": p50, "p95": p95,
            "queue_wait_p50": qw50, "queue_wait_p95": qw95,
            "prefill_p50": pf50, "prefill_p95": pf95,
        }
