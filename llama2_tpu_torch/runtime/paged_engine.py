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

Not ported: the mesh (``dp`` pools).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from llama2_tpu_torch.models.llama import init_cache
from llama2_tpu_torch.models.paged import paged_forward_step, paged_forward_window
from llama2_tpu_torch.ops.cuda.attention_q8 import dequantize_kv, quantize_kv_rows
from llama2_tpu_torch.runtime.batch_engine import BatchEngine, Request
from llama2_tpu_torch.runtime.paged_cache import OutOfPages, PagePool, PrefixCache, _bucket, write_pages


class PagedBatchEngine(BatchEngine):
    """BatchEngine with a paged KV cache (slot planes become page tables).

    ``n_pages`` defaults to ``max(batch_size, batch_size * seq_len // (2 *
    page_size))``, half the rows of a dense cache; page 0 is the scratch page.
    """

    _DENSE_CACHE = False

    def __init__(self, config, params: dict, batch_size: int = 8, n_pages: int | None = None,
                 page_size: int = 256, prefix_cache: bool = False, **kw):
        if kw.get("mesh") is not None:
            raise NotImplementedError("the paged engine's mesh (parallel/dp_paged.py) is not yet ported")
        if n_pages is None:
            n_pages = max(batch_size, (batch_size * config.seq_len) // (2 * page_size))
        super().__init__(config, params, batch_size=batch_size, **kw)
        self.page_size = page_size
        self.pool = self._make_pool(n_pages)
        # page 0 is the scratch page: inactive slots' table rows are all 0, so
        # their frozen-position decode writes land there and never touch a
        # live request's pages
        self._init_free_lists()
        self.max_pages = -(-config.seq_len // page_size)
        self._tables = np.zeros((batch_size, self.max_pages), np.int32)
        self._slot_pages: list[list[int]] = [[] for _ in range(batch_size)]
        self.prefix = PrefixCache() if prefix_cache else None
        self.metrics["prefix_hit_pages"] = 0
        # the dense prefill staging plane, grown on demand to the longest
        # admitted prompt (powers of two, at least 128 rows)
        self._staging = None
        self._coords = None  # the dispatched window's (table, page_ids, row_ids)
        self._spec_table = None  # a speculative tick's table

    def _make_pool(self, n_pages: int) -> PagePool:
        return PagePool.create(self.config, n_pages, self.page_size, self.dtype, self.device,
                               self.kv_quant)

    def _init_free_lists(self):
        self.pool.free = [p for p in self.pool.free if p != 0]

    @property
    def _capacity(self) -> int:
        """Pages one request can ever hold: the pool minus the scratch page."""
        return self.pool.n_pages - 1

    def _rebuild(self):
        self.pool = self._make_pool(self.pool.n_pages)
        self._init_free_lists()
        if self.prefix is not None:
            self.prefix.clear()
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
            self._staging = init_cache(dataclasses.replace(self.config, seq_len=need), 1,
                                       self.dtype, self.device)
        return self._staging

    def _alloc(self, n: int) -> list[int]:
        """Take ``n`` pages, evicting idle prefix-cache pages
        (refcount 0, least recently idle first) under pressure."""
        free = self.pool.free
        if self.prefix is not None and len(free) < n and self.prefix.evictable:
            free.extend(self.prefix.evict(n - len(free)))
        if len(free) < n:
            raise OutOfPages(f"need {n} pages, {len(free)} free")
        return [free.pop() for _ in range(n)]

    def _free_now(self) -> int:
        """Pages obtainable right now: free ones and evictable cached ones."""
        return len(self.pool.free) + (self.prefix.evictable if self.prefix is not None else 0)

    def _release_pages(self, pages: list[int]) -> None:
        """Return pages to the pool; shared prefix pages stay cached."""
        if self.prefix is None:
            self.pool.free.extend(pages)
        else:
            self.pool.free.extend(p for p in pages if not self.prefix.release(p))

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
        if self.prefix is not None:
            while (len(hits) + 1) * ps <= len(feed) - 1:
                page = self.prefix.lookup(feed[: (len(hits) + 1) * ps].tobytes())
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
            self._release_pages(hits)
            if resume:
                # the grown stream cannot fit even an empty pool: return the
                # tokens it has rather than an error
                self._finish(slot_req=req)
            else:
                req.result_q.put(OutOfPages(
                    f"prompt needs {total} pages; pool holds {self._capacity} -- raise n_pages/page_size"
                ))
            return
        if self._free_now() < need:
            # not enough memory now: retry ahead of newer arrivals once
            # running slots retire (the capacity test rules out a livelock)
            self._release_pages(hits)
            self._requeue.append(req)
            return

        # prefill through the dense staging plane: a previous tenant's rows
        # are never read (attention masks to <= pos, and window rows past the
        # prompt go to the scratch page). A cached prefix is copied in first
        # so the suffix attends to it; the prefill starts at p0.
        staging = self._ensure_staging(len(feed))
        if p0:
            self._gather_prefix(staging, hits)
            self.metrics["prefix_hit_pages"] += len(hits)
        logits = self._prefill(staging, feed[p0:], p0)
        pos = len(feed)

        # move the staged rows [p0, pos) into fresh pages through a window of
        # `bucket` rows; rows of the window outside [p0, pos) go to the
        # scratch page. The slot's table is its hit pages, then the new ones.
        pages = self._alloc(self.pool.pages_for(pos) - len(hits))
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
        self._stage_write(staging, row0, bucket, pids, rids)

        # register this stream's newly FULL pages so later admissions can
        # share them (a duplicate key means an identical prompt came first;
        # the page stays private and frees at retire)
        if self.prefix is not None:
            for j in range(len(hits), pos // ps):
                self.prefix.register(feed[: (j + 1) * ps].tobytes(), full[j])

        if self._admitted(slot, req, resume, steps, pos, logits):
            self._slot_pages[slot] = full
            self._tables[slot, : len(full)] = full
        else:
            self._release_pages(full)

    def _gather_prefix(self, staging: dict, hits: list[int]) -> None:
        """Copy the cached prefix pages into the staging plane's first
        ``len(hits) * page`` rows (dequantizing an int8 pool's: the values
        decode attention reads)."""
        idx = torch.as_tensor(hits, device=self.device)
        n = len(hits) * self.page_size
        L, _, KVH, ps, hs = self.pool.k.shape
        for name, pool, spool in (("k", self.pool.k, self.pool.ks), ("v", self.pool.v, self.pool.vs)):
            g = pool[:, idx]  # (L, n_hits, KVH, ps, hs)
            if spool is not None:
                g = dequantize_kv(g, spool[:, idx])
            staging[name][:, 0, :, :n] = g.transpose(1, 2).reshape(L, KVH, n, hs).to(staging[name].dtype)

    def _stage_write(self, staging: dict, row0: int, bucket: int, pids, rids) -> None:
        """Move the staging plane's rows ``row0 .. row0 + bucket - 1`` to
        ``(pids[r], rids[r])`` of the pools; into an int8 pool quantized per
        (row, kv head) on the way (once: prefill itself stays fp)."""
        def rows_of(name):
            # (L, 1, KVH, rows, hs) -> (bucket, L, KVH, hs)
            return staging[name][:, 0, :, row0 : row0 + bucket].permute(2, 0, 1, 3)

        if self.kv_quant:
            for name, pool, spool in (("k", self.pool.k, self.pool.ks), ("v", self.pool.v, self.pool.vs)):
                q, scale = quantize_kv_rows(rows_of(name))
                write_pages(pool, q, pids, rids)
                write_pages(spool, scale, pids, rids)
        else:
            write_pages(self.pool.k, rows_of("k"), pids, rids)
            write_pages(self.pool.v, rows_of("v"), pids, rids)

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
                pgs = self._alloc(need)
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
                    pgs = self._alloc(need)
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
        preempt and recompute, or finish with what it has when alone."""
        self._release_slot(slot)
        if any(r is not None and s != slot for s, r in enumerate(self.slots)):
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
        out = paged_forward_step(
            self.params, self.pool.k, self.pool.v, table, tokens, pos, page_ids[i], row_ids[i],
            self.config, self.backend, self.pool.ks, self.pool.vs,
        )
        return out[0]

    def _spec_forward(self, seg, pos, w: int) -> torch.Tensor:
        if w == 0:
            self._spec_table = self._upload(self._tables)  # the tick's tables, grown for all its windows
        return paged_forward_window(
            self.params, self.pool.k, self.pool.v, self._spec_table, seg, pos, self.config,
            self.backend, self.pool.ks, self.pool.vs,
        )[0]

    def _on_retire(self, slot: int) -> None:
        self._release_slot(slot)

    def _release_slot(self, slot: int):
        self._release_pages(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._tables[slot, :] = 0
