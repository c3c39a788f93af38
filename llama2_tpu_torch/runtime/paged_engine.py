"""Continuous batching over a paged KV cache.

Port of ``llama2_tpu/runtime/paged_engine.py``: the scheduler of
:class:`~llama2_tpu_torch.runtime.batch_engine.BatchEngine` (admit, tick,
retire; the reference's loop semantics), with KV in page pools sized by the
tokens in flight instead of ``batch_size * seq_len``: a slot holds only the
pages its current length needs.

Memory: dense = B*S rows; paged = n_pages*page_size rows, chosen apart.
Prefill stages through one dense plane (a single request's worst case) and
moves its rows into pages; decode appends one row per slot per tick and
takes a page only when a slot crosses a page boundary. Under memory
pressure admission needs the prompt's pages plus one spare; a slot that
still runs dry mid-decode is preempted and recomputed once memory frees
(re-admission replays its emitted stream), unless it is the only active
request, in which case the pool cannot hold it and it finishes with the
tokens it has. ``prefix_cache`` shares the full pages of prompt prefixes
across requests (``runtime/paged_cache.py::PrefixCache``).

With an int8 pool the staging plane stays fp and rows are quantized once,
on their way into pages: a prompt's prefill chunks attend to their own
unquantized rows here, where the dense int8 engine's chunks write their
quantized rows first and attend through them (``models/llama.py::_layer``,
as the JAX package's), which is why paged int8 streams may differ from dense
int8 ones. A prefix hit dequantizes the cached pages back into the plane, so
the suffix attends to the values decode reads.

Speculative windows (``spec_window``) run as the dense engine's, over the
pools (``models/paged.py::paged_forward_window``): the tick flushes the
pipeline, backs every slot's table for ``ticks_per_sync * spec_window``
positions ahead (which may preempt, as a plain tick's growth), and the
window computes its write coordinates from the table on the device.

The mesh (``mesh=``, the server's ``--paged --mesh DPxTP``;
``parallel/dp_paged.py``), decided before the base class's set-up as the JAX
engine's: where ``dp_pool_supported`` accepts the mesh (``n_pages`` rounded
up to a multiple of ``dp``), slots go to data groups in contiguous blocks of
``B/dp``, each group has its own free list of LOCAL page ids (its page 0 its
scratch page) and its own ``PrefixCache``, and each rank holds the pool
shard of its data group's pages and its model index's kv heads, 1/(dp*tp)
of the pool. Every rank runs the same host scheduler for every group (the
lockstep, the broadcast of each step's requests and the all-gather of the
sampled tokens over ``data`` come from ``BatchEngine``), so a slot's pages,
its preemption and the eviction of cached pages stay inside its group.
Where the mesh is refused (``batch_size % dp``), the engine warns that the
pool REPLICATES over data and runs as ``parallel/tp.py::batch_rows`` does
for a ragged batch: every rank holds the whole page axis of its kv heads
and computes every row. ``collective="ring"`` needs the accepted mesh.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from llama2_tpu_torch.models.llama import init_cache
from llama2_tpu_torch.parallel import dp_paged
from llama2_tpu_torch.parallel.mesh import require_data_axis
from llama2_tpu_torch.parallel.sharding import shard_pool
from llama2_tpu_torch.runtime.batch_engine import BatchEngine, Request
from llama2_tpu_torch.runtime.paged_cache import OutOfPages, PrefixCache, _bucket


class PagedBatchEngine(BatchEngine):
    """BatchEngine with a paged KV cache (slot planes become page tables).

    ``n_pages`` defaults to ``max(batch_size, batch_size * seq_len // (2 *
    page_size))``, half the rows of a dense cache; page 0 is the scratch page.
    ``mesh``: see the module's docstring; ``n_pages`` then counts the pages
    of all data groups, and ``pool`` holds the rank's shard.
    """

    _DENSE_CACHE = False

    def __init__(self, config, params: dict, batch_size: int = 8, n_pages: int | None = None,
                 page_size: int = 256, prefix_cache: bool = False, **kw):
        if n_pages is None:
            n_pages = max(batch_size, (batch_size * config.seq_len) // (2 * page_size))
        # the paged mesh path, decided before the base class's set-up (which
        # checks the ring against it) as the JAX engine's __init__ does
        self._dp = 0  # data groups with an allocator each (0: one allocator)
        self._MESH_TICKS = False
        mesh = kw.get("mesh")
        require_data_axis(mesh, type(self).__name__)
        if mesh is not None:
            n_try = -(-n_pages // mesh.dp) * mesh.dp  # page counts round up to the groups
            backend = BatchEngine._mesh_plan(config, params, kw.get("backend", "cuda"), mesh)[0]
            ok, why = dp_paged.dp_pool_supported(mesh, batch_size, n_try, config, params, backend)
            if ok:
                self._dp = mesh.dp if mesh.dp > 1 else 0
                self._MESH_TICKS = True
                n_pages = n_try
            elif mesh.dp > 1:
                warnings.warn(f"paged pool REPLICATES over data (memory does not scale with dp): {why}",
                              stacklevel=2)
        super().__init__(config, params, batch_size=batch_size, **kw)
        if mesh is not None and not self._dp:
            self._rows = slice(0, batch_size)  # every rank computes every row
        # the model group of a rank's reduces, and whether they are the ring's
        self._group = self.fwd_mesh.model_group if self.fwd_mesh is not None and self.fwd_mesh.tp > 1 else None
        self._ring = self.collective == "ring"
        self.page_size = page_size
        self.n_pages = n_pages
        self.pool = self._make_pool()
        # page 0 is the scratch page (of each data group's pages under a
        # mesh): inactive slots' table rows are all 0, so their
        # frozen-position decode writes land there and never touch a live
        # request's pages
        self._init_free_lists()
        self.max_pages = -(-config.seq_len // page_size)
        self._tables = np.zeros((batch_size, self.max_pages), np.int32)
        self._slot_pages: list[list[int]] = [[] for _ in range(batch_size)]
        # one prefix cache a data group under the paged mesh path (its pages
        # are the group's), else one
        self.prefix = None
        if prefix_cache:
            self.prefix = [PrefixCache() for _ in range(self._dp)] if self._dp else PrefixCache()
        self.metrics["prefix_hit_pages"] = 0
        if self._dp:
            self.metrics["prefix_hit_pages_by_shard"] = [0] * self._dp
        # the dense prefill staging plane, grown on demand to the longest
        # admitted prompt (powers of two, at least 128 rows)
        self._staging = None
        self._coords = None  # the dispatched window's (table, page_ids, row_ids)
        self._spec_table = None  # a speculative tick's table

    def _make_pool(self):
        """The rank's pools (``parallel/sharding.py::shard_pool``): pages on
        ``data`` under the paged mesh path, kv heads on ``model``; the whole
        pool without a mesh."""
        c = self.config
        shape = (c.n_layers, self.n_pages, c.n_kv_heads, self.page_size, c.head_size)
        return shard_pool(shape, self.fwd_mesh or (1, 1), self.dtype, self.device, self.kv_quant,
                          pages_on_data=bool(self._dp))

    def _init_free_lists(self):
        """One free list of the pool's ids without page 0; under the paged
        mesh path one a data group, of its LOCAL ids without its page 0."""
        if self._dp:
            self._free = [list(range(self.pool.n_pages - 1, 0, -1)) for _ in range(self._dp)]
            self.pool.free = []  # unused: the groups' lists hold the ids
        else:
            self.pool.free = [p for p in self.pool.free if p != 0]

    def _shard_of(self, slot: int) -> int:
        """The data group that owns ``slot``: slots go in contiguous blocks
        of ``B/dp``, as the rows of a tick."""
        return slot // (self.batch_size // self._dp) if self._dp else 0

    def _free_list(self, slot: int) -> list[int]:
        return self._free[self._shard_of(slot)] if self._dp else self.pool.free

    def _prefix_of(self, slot: int):
        if self.prefix is None:
            return None
        return self.prefix[self._shard_of(slot)] if self._dp else self.prefix

    def _owns(self, slot: int) -> bool:
        """Whether this rank's pool shard holds ``slot``'s pages."""
        return not self._dp or self._shard_of(slot) == self.mesh.coord[0]

    @property
    def _capacity(self) -> int:
        """Pages one request can ever hold: its group's pages (the rank's
        shard's) minus the scratch page."""
        return self.pool.n_pages - 1

    def _rebuild(self):
        self.pool = self._make_pool()
        self._init_free_lists()
        if self.prefix is not None:
            for pfx in self.prefix if self._dp else [self.prefix]:
                pfx.clear()
        self._tables[:] = 0
        self._slot_pages = [[] for _ in range(self.batch_size)]
        self._staging = None

    def _ensure_staging(self, rows: int) -> dict:
        """Grow the prefill staging plane to cover ``rows`` positions."""
        S = self.config.seq_len
        need = 128
        while need < min(rows, S):
            need *= 2
        need = min(need, S)
        cur = 0 if self._staging is None else self._staging["k"].shape[3]
        if cur < need:
            # the rank's kv heads under a mesh
            self._staging = init_cache(dataclasses.replace(self.local_config, seq_len=need), 1,
                                       self.dtype, self.device)
        return self._staging

    def _alloc(self, n: int, slot: int = 0) -> list[int]:
        """Take ``n`` pages for ``slot`` (from its data group's under the
        paged mesh path), evicting idle prefix-cache pages (refcount 0,
        least recently idle first) under pressure."""
        free, pfx = self._free_list(slot), self._prefix_of(slot)
        if pfx is not None and len(free) < n and pfx.evictable:
            free.extend(pfx.evict(n - len(free)))
        if len(free) < n:
            raise OutOfPages(f"need {n} pages, {len(free)} free")
        return [free.pop() for _ in range(n)]

    def _free_now(self, slot: int) -> int:
        """Pages obtainable right now for ``slot``: free ones and evictable
        cached ones (of its data group)."""
        pfx = self._prefix_of(slot)
        return len(self._free_list(slot)) + (pfx.evictable if pfx is not None else 0)

    def _release_pages(self, pages: list[int], slot: int) -> None:
        """Return ``slot``'s pages to its free list; shared prefix pages stay
        cached."""
        free, pfx = self._free_list(slot), self._prefix_of(slot)
        if pfx is None:
            free.extend(pages)
        else:
            free.extend(p for p in pages if not pfx.release(p))

    def _start_request(self, slot: int, req: Request):
        # prefill writes pools, tables and mirrors outside the pipelined
        # chain: flush the windows in flight first
        self._drain(0)
        fed = self._feed(req)
        if fed is None:
            return
        resume, steps, feed = fed

        # prefix-cache hits: the longest chain of cached FULL pages matching
        # the feed (at most len(feed) - 1 rows, so at least one token
        # prefills and the first token's logits exist)
        ps = self.page_size
        hits: list[int] = []
        pfx = self._prefix_of(slot)
        if pfx is not None:
            while (len(hits) + 1) * ps <= len(feed) - 1:
                page = pfx.lookup(feed[: (len(hits) + 1) * ps].tobytes())
                if page is None:
                    break
                hits.append(page)
        p0 = len(hits) * ps

        # admission control: the stream's pages plus one spare for decode
        # growth. ``need`` must come off the free list now (hit pages are
        # resident and referenced); the can-never-fit test takes the whole.
        total = self.pool.pages_for(len(feed)) + 1
        need = total - len(hits)
        if total > self._capacity:
            self._release_pages(hits, slot)
            if resume:
                # the grown stream cannot fit even an empty pool: return the
                # tokens it has rather than an error
                self._finish(slot_req=req)
            else:
                req.result_q.put(OutOfPages(
                    f"prompt needs {total} pages; pool holds {self._capacity} -- raise n_pages/page_size"
                ))
            return
        if self._free_now(slot) < need:
            # not enough memory now: retry ahead of newer arrivals once
            # running slots retire (the capacity test rules out a livelock)
            self._release_pages(hits, slot)
            self._requeue.append(req)
            return

        # prefill through the dense staging plane: a previous tenant's rows
        # are never read (attention masks to <= pos, and window rows past the
        # prompt go to the scratch page). A cached prefix is copied in first
        # so the suffix attends to it; the prefill starts at p0.
        staging = self._ensure_staging(len(feed))
        if p0:
            dp_paged.gather_prefix(staging, self.pool, hits, self._shard_of(slot), self.mesh)
            self.metrics["prefix_hit_pages"] += len(hits)
            if self._dp:
                self.metrics["prefix_hit_pages_by_shard"][self._shard_of(slot)] += len(hits)
        logits = self._prefill(staging, feed[p0:], p0)
        pos = len(feed)

        # move the staged rows [p0, pos) into fresh pages through a window of
        # `bucket` rows; rows of the window outside [p0, pos) go to the
        # scratch page. The slot's table is its hit pages, then the new ones.
        pages = self._alloc(self.pool.pages_for(pos) - len(hits), slot)
        full = hits + pages
        table = np.asarray(full, np.int64)
        plane_rows = staging["k"].shape[3]
        bucket = min(_bucket(pos - p0), self.config.seq_len)
        # The window starts at p0 where it fits in the plane, else ends at
        # the plane's last row (the rows before p0 then go to the scratch
        # page). The JAX engine clamps it against seq_len instead
        # (paged_engine.py:696), not against the plane's rows: on a prefix
        # hit with a suffix past 128 tokens its window runs off the plane,
        # dynamic_slice shifts it back, and the rows land in the wrong
        # pages. Here the window always lies inside the plane.
        row0 = max(0, min(p0, plane_rows - bucket))
        logical = row0 + np.arange(bucket)
        real = (logical >= p0) & (logical < pos)
        page_idx = np.minimum(logical // ps, len(full) - 1)
        pids = torch.as_tensor(np.where(real, table[page_idx], 0), device=self.device)
        rids = torch.as_tensor(np.where(real, logical % ps, 0), device=self.device)
        dp_paged.stage_write(self.pool, staging, row0, bucket, pids, rids, own=self._owns(slot))

        # register this stream's newly FULL pages so later admissions can
        # share them (a duplicate key means an identical prompt came first;
        # the page stays private and frees at retire)
        if pfx is not None:
            for j in range(len(hits), pos // ps):
                pfx.register(feed[: (j + 1) * ps].tobytes(), full[j])

        if self._admitted(slot, req, resume, steps, pos, logits):
            self._slot_pages[slot] = full
            self._tables[slot, : len(full)] = full
        else:
            self._release_pages(full, slot)

    def _grow_tables(self, K: int) -> None:
        """Make sure pages back each active slot's next K positions, from the
        pipelined position projection (slots frozen on the device still write
        at the precomputed coordinates, so the whole window must be backed).
        Under memory pressure with windows in flight, flush the pipeline first
        (the retires replayed there free pages, and pages must NEVER be
        released while an unread window may still write them) and retry
        before preempting."""
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            need = self._pages_short(slot, K)
            if need <= 0:
                continue
            try:
                pgs = self._alloc(need, slot)
            except OutOfPages:
                if not self._inflight:
                    self._preempt(slot, req)
                    continue
                self._drain(0)
                self._pos_ahead = self._pos.copy()
                if self.slots[slot] is None:
                    continue  # retired during the flush
                # the flush reset the projection: the true requirement
                need = self._pages_short(slot, K)
                if need <= 0:
                    continue
                try:
                    pgs = self._alloc(need, slot)
                except OutOfPages:
                    self._preempt(slot, req)
                    continue
            base = len(self._slot_pages[slot])
            self._tables[slot, base : base + len(pgs)] = pgs
            self._slot_pages[slot].extend(pgs)

    def _pages_short(self, slot: int, K: int) -> int:
        """Pages ``slot`` lacks for its next K positions."""
        last = min((int(self._pos_ahead[slot]) + K - 1) // self.page_size, self.max_pages - 1)
        return last + 1 - len(self._slot_pages[slot])

    def _preempt(self, slot: int, req: Request):
        """Out of pages for ``slot`` (the pipeline already flushed):
        preempt and recompute, or finish with what it has when alone in its
        data group (only the group's slots free its pages)."""
        self._release_slot(slot)
        group = self._shard_of(slot)
        if any(r is not None and s != slot and self._shard_of(s) == group for s, r in enumerate(self.slots)):
            # drop its pages and requeue it at the head, to restart once a
            # retiring request frees memory; tokens and steps are KEPT, so
            # re-admission teacher-forces the emitted stream and resumes in
            # place
            self.slots[slot] = None
            self._requeue.append(req)
            self.metrics["preempted"] += 1
        else:
            # alone and out of memory: the pool cannot hold this request
            self._finish(slot_req=req, slot=slot)

    def _decode_tick(self):
        if self._spec_ready():
            # flush first (the windows read the host's histories and
            # cannot chain), then back every slot's table for the whole
            # span of the tick's windows: a window's advance depends on the
            # data, so the device computes its write coordinates from the
            # table and the host only makes sure the pages exist. The growth
            # may preempt: the spec tick reads the slots after it.
            self._drain(0)
            self._pos_ahead = self._pos.copy()
            if any(self.slots):
                self._grow_tables(self.ticks_per_sync * self.spec_window)
            if any(self.slots):
                self._spec_tick()
            return
        K = self.ticks_per_sync
        if self._chain is None:
            self._pos_ahead = self._pos.copy()  # a fresh pipeline: the mirrors are current
        self._grow_tables(K)
        if not any(self.slots):
            self._drain(0)
            return
        self._dispatch_tick(np.asarray([r is not None for r in self.slots]))
        self._drain(self.pipeline_depth - 1)

    def _dispatch_tick(self, active: np.ndarray):
        """The write coordinates of the window's K steps, (K, B), from the
        host's position projection (slots frozen on the device overwrite
        ahead of their final position, inside their own pages; inactive
        slots write the scratch page), then the base class's window."""
        K = self.ticks_per_sync
        win = np.minimum(self._pos_ahead[None, :] + np.arange(K)[:, None], self.config.seq_len - 1)
        page_ids = self._tables[np.arange(self.batch_size)[None, :], win // self.page_size]
        self._coords = (self._upload(self._tables), self._upload(page_ids.astype(np.int32)),
                        self._upload((win % self.page_size).astype(np.int32)))
        super()._dispatch_tick(active)

    def _decode_step(self, tokens, pos, i: int) -> torch.Tensor:
        table, page_ids, row_ids = self._coords
        return dp_paged.tick(self.params, self.pool, table, tokens, pos, page_ids[i], row_ids[i],
                             self.local_config, self.backend, self._rows, self._group, self._ring)

    def _spec_forward(self, seg, pos, w: int) -> torch.Tensor:
        if w == 0:
            self._spec_table = self._upload(self._tables)  # the tick's tables, grown for all its windows
        return dp_paged.window(self.params, self.pool, self._spec_table, seg, pos, self.local_config,
                               self.backend, self._rows, self._group, self._ring)

    def _on_retire(self, slot: int) -> None:
        self._release_slot(slot)

    def _release_slot(self, slot: int):
        self._release_pages(self._slot_pages[slot], slot)
        self._slot_pages[slot] = []
        self._tables[slot, :] = 0
