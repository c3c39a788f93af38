"""Paged KV cache: device page pools and the host page allocator.

Port of ``llama2_tpu/runtime/paged_cache.py``. K and V live in layer-stacked
page pools ``(L, n_pages, KVH, page_size, hs)`` (no padding of the head
dim), and every request holds only the pages its current length needs. The
allocator is host bookkeeping (a free list; allocation runs at admission and
retirement rate); the device sees int32 page tables, read by the paged
attention kernels (``ops/cuda/paged_attention.py``).

Rows are written by indexed assignment, ``pool[:, page_ids, :, row_ids] =
rows`` (see :func:`write_pages`), in place: the JAX package scans row by row
only to keep XLA from copying the pool. :func:`write_segment` and
:func:`append` are the JAX package's public writers of fp pools, with its
signatures; where two rows of one call share an address, the later row
wins, as in the JAX scans.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from llama2_tpu_torch.config import ModelConfig


class OutOfPages(RuntimeError):
    pass


@dataclasses.dataclass
class PagePool:
    """Device pools (the layers stacked on dim 0) and the host free list.

    An int8 pool (``kv_quant``) holds int8 rows ``k``/``v`` and float32 per-row
    scales ``ks``/``vs`` of shape (L, P, KVH, page)."""

    k: torch.Tensor  # (L, P, KVH, page, hs): f32/bf16, or int8
    v: torch.Tensor
    page_size: int
    free: list[int]
    ks: torch.Tensor | None = None  # (L, P, KVH, page) float32
    vs: torch.Tensor | None = None

    @classmethod
    def create(
        cls,
        config: ModelConfig,
        n_pages: int,
        page_size: int = 256,
        dtype=torch.float32,
        device="cpu",
        kv_quant: bool = False,
    ) -> "PagePool":
        shape = (config.n_layers, n_pages, config.n_kv_heads, page_size, config.head_size)
        return cls.zeros(shape, dtype, device, kv_quant)

    @classmethod
    def zeros(cls, shape: tuple, dtype=torch.float32, device="cpu", kv_quant: bool = False) -> "PagePool":
        """Zeroed pools of ``shape`` (L, P, KVH, page, hs), every page free."""
        free = list(range(shape[1] - 1, -1, -1))
        if kv_quant:
            return cls(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                ks=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                vs=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                page_size=shape[3],
                free=free,
            )
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            page_size=shape[3],
            free=free,
        )

    @property
    def kv_quant(self) -> bool:
        return self.ks is not None

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]

    @property
    def tensors(self) -> tuple:
        """The pools in the argument order of the paged kernels: (k, v), or
        (k, ks, v, vs) for an int8 pool."""
        return (self.k, self.ks, self.v, self.vs) if self.kv_quant else (self.k, self.v)

    def alloc(self, n: int) -> list[int]:
        if len(self.free) < n:
            raise OutOfPages(f"need {n} pages, {len(self.free)} free")
        return [self.free.pop() for _ in range(n)]

    def release(self, pages: list[int]) -> None:
        self.free.extend(pages)

    def pages_for(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.page_size))


class PrefixCache:
    """Host-side registry of FULL KV pages keyed by their causal token prefix
    (automatic prefix caching).

    A page covering positions [j*ps, (j+1)*ps) of a teacher-forced stream is
    a pure function of the first (j+1)*ps fed tokens, so that token prefix
    (as bytes) is the key. Only full pages are shared: a partial tail page is
    private to its request, and decode writes land at positions at or past
    the prompt's end, so shared pages are never written again.

    Refcounts count the slots holding a page. At zero the page stays CACHED
    and joins an LRU of evictable pages; the engine's allocator evicts from
    it back to the free list only under memory pressure: the pool itself is
    the cache's budget.
    """

    def __init__(self):
        self.key2page: dict[bytes, int] = {}
        self.page2key: dict[int, bytes] = {}
        self.refs: dict[int, int] = {}
        self._lru: dict[int, None] = {}  # insertion-ordered set of ref-0 pages
        self.hits = 0
        self.misses = 0

    def lookup(self, key: bytes) -> int | None:
        """Take a reference on the page for ``key`` if cached."""
        page = self.key2page.get(key)
        if page is None:
            self.misses += 1
            return None
        self.refs[page] += 1
        self._lru.pop(page, None)
        self.hits += 1
        return page

    def register(self, key: bytes, page: int) -> bool:
        """Register an owned page under ``key`` (the caller's ref counts)."""
        if key in self.key2page or page in self.page2key:
            return False
        self.key2page[key] = page
        self.page2key[page] = key
        self.refs[page] = 1
        return True

    def release(self, page: int) -> bool:
        """Drop one reference. True: the page stays cached (do NOT free it)."""
        if page not in self.page2key:
            return False
        self.refs[page] -= 1
        if self.refs[page] == 0:
            self._lru[page] = None
        return True

    @property
    def evictable(self) -> int:
        return len(self._lru)

    def evict(self, n: int) -> list[int]:
        """Unregister up to ``n`` least-recently idle pages and return them
        (the caller puts them back on the free list)."""
        out = []
        while self._lru and len(out) < n:
            page = next(iter(self._lru))  # the oldest idle entry
            del self._lru[page]
            out.append(page)
            del self.key2page[self.page2key.pop(page)]
            del self.refs[page]
        return out

    def clear(self):
        self.key2page.clear()
        self.page2key.clear()
        self.refs.clear()
        self._lru.clear()


def write_pages(pool: torch.Tensor, rows: torch.Tensor, page_ids: torch.Tensor,
                row_ids: torch.Tensor) -> None:
    """Write ``rows`` (R, L, KVH, ...) into ``pool`` (L, P, KVH, page, ...) at
    ``[:, page_ids[r], :, row_ids[r]]``, in place. Coordinates two rows share
    (the scratch page's) get one of them."""
    pool[:, page_ids, :, row_ids] = rows.to(pool.dtype)


def _check_fp(pool: PagePool, what: str) -> None:
    if pool.kv_quant:
        raise ValueError(f"{what} writes fp pools; an int8 pool takes quantized rows and scales")


def write_segment(pool: PagePool, k_rows: torch.Tensor, v_rows: torch.Tensor, table,
                  pos0: int) -> PagePool:
    """Write a prefilled segment's K/V rows (L, T, KVH, hs), positions
    ``pos0 .. pos0 + T - 1``, through the slot's page table (host ints in
    logical order), in place; returns the pool.

    The JAX version pads the rows to a power-of-two bucket by repeating the
    last row at its own address, an idempotent rewrite that bounds its jit
    specializations; nothing here needs it. Of rows sharing an address (a
    table that names one page twice), the later is kept.
    """
    _check_fp(pool, "write_segment")
    T = k_rows.shape[1]
    logical = np.arange(pos0, pos0 + T)
    page_ids = np.asarray(table, dtype=np.int64)[logical // pool.page_size]
    row_ids = logical % pool.page_size
    addr = page_ids * pool.page_size + row_ids
    _, first_from_end = np.unique(addr[::-1], return_index=True)
    keep = np.sort(T - 1 - first_from_end)  # each address's last row
    device = pool.k.device
    pages_t = torch.from_numpy(page_ids[keep]).to(device)
    rows_t = torch.from_numpy(row_ids[keep]).to(device)
    idx = torch.from_numpy(keep).to(k_rows.device)
    for dst, rows in ((pool.k, k_rows), (pool.v, v_rows)):
        write_pages(dst, rows.transpose(0, 1)[idx], pages_t, rows_t)
    return pool


def append(pool: PagePool, k_rows: torch.Tensor, v_rows: torch.Tensor, page_ids, row_ids,
           active=None) -> PagePool:
    """Batched decode append: slot b's rows ``k_rows[:, b]`` (L, KVH, hs) at
    ``[:, page_ids[b], :, row_ids[b]]``, in place; returns the pool.

    Slots write in batch order, so a later slot wins an address two slots
    share: each slot writes the rows of the last slot with its address, so
    the one indexed write is exact, with no host read of the coordinates.
    ``active`` is taken for the JAX signature and unused, as there: an
    inactive slot writes its frozen coordinates.
    """
    _check_fp(pool, "append")
    device = pool.k.device
    page_ids = torch.as_tensor(page_ids, device=device).long()
    row_ids = torch.as_tensor(row_ids, device=device).long()
    addr = page_ids * pool.page_size + row_ids
    order = torch.arange(addr.shape[0], device=device)
    last = torch.where(addr[:, None] == addr[None, :], order[None, :], -1).amax(1)
    last = last.to(k_rows.device)
    for dst, rows in ((pool.k, k_rows), (pool.v, v_rows)):
        write_pages(dst, rows[:, last].transpose(0, 1), page_ids, row_ids)
    return pool


def _bucket(T: int) -> int:
    """The next power of two >= max(T, 32): the rows of the staging-plane
    window that a prefill of T rows moves into pages, as the JAX engine's
    (which bounds its jit specializations so); the window's rows outside
    the prefill go to the scratch page."""
    b = 32
    while b < T:
        b *= 2
    return b
