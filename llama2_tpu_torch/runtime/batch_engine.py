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

Tensor and data parallelism (``mesh=``, a ``parallel/mesh.py`` Mesh; the
server's ``--mesh DPxTP``): every rank runs this engine on its shards of the
weights and the cache (``parallel/sharding.py``; kv heads on ``model``,
slots on ``data``), the layer stack through ``forward(mesh=)``
(``parallel/tp.py``). The ranks step in LOCKSTEP: rank 0 takes the
submissions, and before each step it broadcasts that step's new requests
and its stop signal over the world; every rank then applies them and steps
alike. An admission's prefill is computed by every data group (the B = 1
plane replicates over ``data``, as in the JAX package), and only the group
that owns the slot writes its rows, so every rank knows the first token. A
tick computes the rank's own ``B/dp`` rows, and the sampled tokens (a
speculative window's targets) are all-gathered over ``data``, so that every
scheduler agrees; a sampled slot draws from its own seed, the same on every
rank. Where the CUDA kernels cannot shard the model
(``tp_cuda_supported``), the engine warns and runs ``backend="torch"``,
decided from the shapes before any launch; where not even the plain path
shards it, every rank holds the whole model (with a warning). Under a mesh
an error in a step is fatal (the ranks' states would part): every request
fails and the loop ends. ``collective="ring"`` (the server's
``--collective-matmul``) makes the row-parallel ``wo``/``w2`` reduces the
overlapped ring collective matmul's (``parallel/collective_matmul.py``):
a ring reduce-scatter of point-to-point hops beside the column-chunk
products, then a ring all-gather; the FFN is then the composed one. It
needs a model ``tp_ring_supported`` accepts, and on a paged engine the
paged mesh path (``parallel/dp_paged.py``); without a mesh it does nothing.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from llama2_tpu_torch.config import GenerationConfig, ModelConfig
from llama2_tpu_torch.models.llama import BACKENDS, forward, init_cache, layer_keys, logits_from_hidden
from llama2_tpu_torch.ops import sampling
from llama2_tpu_torch.ops.cuda import attention, attention_q8, build, layer_block, mlp_block, quant_matmul
from llama2_tpu_torch.parallel.mesh import require_data_axis
from llama2_tpu_torch.parallel.sharding import LocalParams, shard_params
from llama2_tpu_torch.parallel.tp import (
    batch_rows,
    gather,
    local_config,
    tp_cuda_supported,
    tp_ring_supported,
)
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

    ``mesh``: this rank's ``(data, model)`` Mesh (see the module's
    docstring); ``params`` the whole tree (a memory-mapped param cache: only
    the rank's slices are read), which the engine cuts for the mesh it runs
    (``_shard``); ``device`` defaults to the rank's. Rank 0 takes
    submissions and runs :meth:`start`, the others :meth:`follow`.
    ``collective="ring"``: the row-parallel reduces by the overlapped ring
    collective matmul (``parallel/collective_matmul.py``), under a mesh.
    """

    _DENSE_CACHE = True  # PagedBatchEngine: pools replace the slot planes
    # whether the engine's ticks run the mesh path the ring needs (the paged
    # engine decides it per instance: its paged mesh path, dp_paged.py)
    _MESH_TICKS = True

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
        mesh=None,
        collective: str | None = None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
        if collective not in (None, "ring"):
            raise ValueError(f"unknown collective {collective!r}")
        require_data_axis(mesh, type(self).__name__)
        self.config = config
        self.batch_size = batch_size
        # mesh: the rank's place in the world; fwd_mesh: the one forward()
        # runs on (the same, or replicated over model for a model that does
        # not shard)
        self.mesh = mesh
        self.fwd_mesh = None
        # the ring collective matmul for the row-parallel reduces: under a
        # mesh only (without one it does nothing, as in the JAX engine)
        self.collective = collective if mesh is not None else None
        if mesh is not None:
            if collective == "ring":
                if not self._MESH_TICKS:
                    raise ValueError(
                        "collective='ring' on a paged engine requires the paged mesh path "
                        "(a dp_pool_supported mesh, parallel/dp_paged.py)"
                    )
                ok, why = tp_ring_supported(params, config, mesh)
                if not ok:
                    raise ValueError(f"collective='ring' unsupported here: {why}")
            backend, self.fwd_mesh, params = self._shard(config, params, backend, mesh)
            device = mesh.device if device is None else device
        self.backend = backend
        self.dtype = dtype
        self.device = resolve_device(device)
        self.params = prepare_params(params, dtype, backend, self.device, ring=self.collective == "ring")
        # the rank's view of the model and its rows of the batch
        self.local_config = config if self.fwd_mesh is None else local_config(config, self.fwd_mesh.tp)
        self._rows = slice(0, batch_size) if self.fwd_mesh is None else batch_rows(batch_size, self.fwd_mesh)
        self._scratch = None  # the prefill plane of a slot another data group owns
        self._lockstep_on = mesh is not None and mesh.size > 1
        self._arrivals: "queue.Queue[Request]" = queue.Queue()  # the requests of the lockstep
        self.followed: list = []  # a follower's mirrored requests' result queues, in arrival order
        self.failed: Exception | None = None
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

    @staticmethod
    def _mesh_plan(config, params, backend: str, mesh) -> tuple[str, str, str]:
        """``(backend, why it fell back to torch, why the model
        replicates)`` of an engine on ``mesh`` with the whole tree
        ``params``, decided from the shapes alone: ``torch`` where the CUDA
        kernels cannot shard the model (``tp_cuda_supported``, the JAX
        engine's rule), and every rank holding the whole model where the
        plain path cannot either ("" where it does not)."""
        fell = shared = ""
        if backend.startswith("cuda"):
            ok, fell = tp_cuda_supported(params, config, mesh)
            if not ok:
                backend = "torch"
        if backend == "torch":
            shared = tp_ring_supported(params, config, mesh)[1]
        return backend, fell, shared

    @classmethod
    def _shard(cls, config, params, backend: str, mesh):
        """``(backend, forward mesh, the rank's slices)`` of an engine on
        ``mesh`` with the whole tree ``params`` (:meth:`_mesh_plan`; each
        fallback warned): ``mesh``, or ``mesh`` replicated over ``model``."""
        if isinstance(params, LocalParams):
            raise TypeError(
                "BatchEngine(mesh=) takes the whole param tree (a param cache memory-mapped by "
                "io/cache.py::load_cache is read only where the rank's slices lie) and cuts the slices itself"
            )
        run, fell, shared = cls._mesh_plan(config, params, backend, mesh)
        if fell:
            warnings.warn(
                f"mesh {mesh.dp}x{mesh.tp} with backend {backend!r}: the CUDA kernels cannot shard "
                f"this model ({fell}); falling back to backend='torch'",
                stacklevel=3,
            )
        fwd = mesh
        if shared:
            warnings.warn(
                f"mesh {mesh.dp}x{mesh.tp}: the model does not shard ({shared}); every rank holds "
                "the whole model (replicated over model)",
                stacklevel=3,
            )
            fwd = mesh.replicated_over_model()
        return run, fwd, shard_params(params, fwd)

    def _make_cache(self):
        # padded past seq_len by a window, so that a window from the last
        # position never runs off the cache onto committed rows; the rank's
        # rows and kv heads under a mesh
        rows = self._rows.stop - self._rows.start
        return init_cache(self.local_config, rows, self.dtype, self.device, self.kv_quant, pad=self.spec_window)

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
        if self.failed is not None:
            req.result_q.put(self.failed)
        else:
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
        """Synchronous drive (tests, batch jobs): process the queue to
        completion. Under a mesh every rank calls it, rank 0 after its
        submissions."""
        while max_ticks > 0:
            self._lockstep()
            if not self._busy():
                break
            self._step()
            max_ticks -= 1

    def follow(self):
        """A follower rank's loop (every rank but 0 under a mesh): step in
        lockstep with rank 0 until it stops; raises what failed the loop."""
        self._loop()
        if self.failed is not None:
            raise self.failed

    # ---- engine internals ----

    def _source(self) -> "queue.Queue[Request]":
        """Where admissions come from: the submissions, or under a mesh the
        requests the lockstep delivered."""
        return self._arrivals if self._lockstep_on else self.waiting

    def _lockstep(self) -> bool:
        """Under a mesh, rank 0 broadcasts the requests submitted since the
        last step and its stop signal, and every rank queues the requests
        for admission in that order (a follower's mirrors' results go to
        ``followed``). Returns the stop signal."""
        if not self._lockstep_on:
            return self._stop.is_set()
        new = []
        if self.mesh.rank == 0:
            while True:
                try:
                    new.append(self.waiting.get_nowait())
                except queue.Empty:
                    break
            msg = [[(r.prompt, r.gen) for r in new], self._stop.is_set()]
        else:
            msg = [None, None]
        dist.broadcast_object_list(msg, src=0, group=self.mesh.control_group)
        if self.mesh.rank != 0:
            for prompt, gen in msg[0]:
                req = Request(prompt=prompt, gen=gen, result_q=queue.Queue())
                self.followed.append(req.result_q)
                new.append(req)
        for req in new:
            self._arrivals.put(req)
        return msg[1]

    def _busy(self) -> bool:
        return bool(not self._source().empty() or self._requeue or any(self.slots) or self._inflight)

    def _loop(self):
        while True:
            try:
                if self._lockstep():
                    break
                if not self._busy():
                    time.sleep(0.005 if self._lockstep_on else 0.001)
                    continue
                self._step()
            except Exception as e:  # noqa: BLE001 -- rebuild and re-queue
                if not self._lockstep_on:
                    self._recover(e)
                    continue
                # the ranks' states may have parted: end every request and the loop
                self.failed = e
                self._fail_all(e)
                break

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
        for source in (self._arrivals, self.waiting):
            while True:
                try:
                    req = source.get_nowait()
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
                    req = self._source().get_nowait()
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
            logits = self._chunk(self.params, self.config, cache, remaining[:c], pos, self.fwd_mesh)
            pos += c
            remaining = remaining[c:]
        return logits

    def _chunk(self, params: dict, config: ModelConfig, cache: dict, seg: np.ndarray, pos: int, mesh=None):
        """One prefill chunk ``seg`` at ``pos`` into a batch-1 cache: the
        last position's logits (V,)."""
        seg = torch.as_tensor(seg[None, :], device=self.device)
        if seg.shape[1] == 1 and not all(t.is_contiguous() for t in cache.values()):
            # a one-token chunk runs the decode layer, whose kernels take
            # whole layer-stacked caches: the slot's plane, copied there
            # and back (the JAX engine copies the plane for every chunk)
            plane = {k: t.contiguous() for k, t in cache.items()}
            hidden = forward(params, plane, seg, pos, config, self.backend, mesh, self.collective)
            for k, t in cache.items():
                t.copy_(plane[k])
        else:
            hidden = forward(params, cache, seg, pos, config, self.backend, mesh, self.collective)
        return logits_from_hidden(params, hidden[:, -1, :], self.backend, mesh)[0]

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
        if self.mesh is not None:
            warnings.warn("precompile: a mesh engine builds and plans at its first request", stacklevel=2)
            return 0
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
        logits = self._prefill(self._plane(slot), feed, 0)
        self._admitted(slot, req, resume, steps, len(feed), logits)

    def _plane(self, slot: int) -> dict:
        """The slot's plane of the batched cache, a view the prefill writes;
        under a mesh, for a slot another data group owns, a scratch plane
        (every data group computes the prefill, the owner keeps it)."""
        lo, hi = self._rows.start, self._rows.stop
        if lo <= slot < hi:
            return {k: v[:, slot - lo : slot - lo + 1] for k, v in self.cache.items()}
        if self._scratch is None:
            self._scratch = init_cache(self.local_config, 1, self.dtype, self.device, self.kv_quant,
                                       pad=self.spec_window)
        return self._scratch

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
            targets = self._gather_rows(
                sampling.sample_argmax(logits_from_hidden(self.params, hidden, self.backend, self.fwd_mesh))
            )
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
        return forward(self.params, self.cache, seg, pos, self.config, self.backend, self.fwd_mesh, self.collective)

    def _decode_step(self, tokens, pos, i: int) -> torch.Tensor:
        """Step ``i`` of a window: the (B, 1, D) hidden states of one decode
        step of every slot, the rank's rows under a mesh (the paged engine
        runs its own)."""
        return forward(self.params, self.cache, tokens[:, None], pos, self.config, self.backend, self.fwd_mesh,
                       self.collective)

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The whole batch's rows of ``t`` (the rank's rows under a mesh),
        all-gathered over the data group."""
        if self._rows == slice(0, self.batch_size):
            return t
        return gather(t, self.fwd_mesh.data_group, 0)

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
            logits = logits_from_hidden(self.params, hidden[:, -1, :], self.backend, self.fwd_mesh)
            nxt = self._gather_rows(self._sample(logits, sampled, None if draws is None else draws[i]))
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
        """The next token of every slot of the engine's rows (all of them,
        or the rank's under a mesh) from its (V,) logits row: the argmax, or
        for the ``sampled`` slots the nucleus sampler with the slot's draw
        (``top_p`` in {0, 1} samples the whole vocabulary)."""
        greedy = sampling.sample_argmax(logits)
        lo, hi = self._rows.start, self._rows.stop
        sampled = [b for b in sampled if lo <= b < hi]
        if not sampled:
            return greedy
        rows = list(greedy.unbind())
        for b in sampled:
            p = self._topp[b]
            p_eff = 1.0 if p <= 0.0 or p >= 1.0 else p
            probs = sampling.probs_from_logits(logits[b - lo], self._temp[b])
            rows[b - lo] = sampling.sample_top_p(probs, p_eff, draws[b])
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
