"""The torch port's read-only paged decode attention K14 and the paged pool
writers ``write_segment`` / ``append`` against the JAX package.

* K14: on the CPU ``paged_decode_attention`` runs its plain version, held
  against ``llama2_tpu/ops/pallas/paged_attention.py::paged_decode_attention``
  (interpret mode) over the ``pos x gqa`` grid of
  ``tests/test_paged.py::test_paged_attention_matches_dense``: two rows whose
  pages are scrambled, float32, atol 2e-5 (that test's); and against the
  port's ``paged_attention_oracle``.
* ``write_segment`` then K14, against JAX's ``write_segment`` then K14
  (``tests/test_paged.py:69-107``): the pool bytes equal, the output to 2e-5.
* ``append`` against JAX's (``tests/test_paged.py:109-143``): pool bytes
  equal; two slots sharing an address, where the later slot wins, and a
  segment whose table names one page twice, where the later row wins.
* On an int8 pool both writers raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from llama2_tpu.ops.pallas.paged_attention import paged_decode_attention as jax_k14
from llama2_tpu.runtime import paged_cache as jpc
from llama2_tpu_torch.config import ModelConfig as TorchModelConfig
from llama2_tpu_torch.ops.cuda import paged_attention as tpa
from llama2_tpu_torch.runtime import paged_cache as tpc

ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _configs():
    c = tiny_config()
    fields = ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size", "seq_len", "norm_eps")
    return c, TorchModelConfig(**{f: getattr(c, f) for f in fields})


def _assert_pools_equal(tpool, jpool):
    np.testing.assert_array_equal(tpool.k.numpy(), np.asarray(jpool.k))
    np.testing.assert_array_equal(tpool.v.numpy(), np.asarray(jpool.v))


@pytest.mark.parametrize("pos", [0, 5, 16, 31, 47])
@pytest.mark.parametrize("gqa", [False, True])
def test_paged_decode_vs_jax_kernel(pos, gqa):
    P, KVH, page, hs, B = 6, 2, 16, 32, 2
    H = 4 if gqa else KVH
    rng = np.random.default_rng(pos * 10 + gqa)
    k = rng.standard_normal((P, KVH, page, hs), dtype=np.float32)
    v = rng.standard_normal((P, KVH, page, hs), dtype=np.float32)
    q = rng.standard_normal((B, 1, H, hs), dtype=np.float32)
    table = np.stack([rng.permutation(P)[: P // 2 + 1] for _ in range(B)]).astype(np.int32)
    positions = np.asarray([pos, max(0, pos - 3)], np.int32)
    want = np.asarray(jax_k14(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
                              jnp.asarray(positions)))
    before = tpa.paged_decode_attention.launches
    got = tpa.paged_decode_attention(_t(q), _t(k), _t(v), _t(table), _t(positions))
    assert tpa.paged_decode_attention.launches == before  # CPU tensors: plain, no launch
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    oracle = tpa.paged_attention_oracle(_t(q), _t(k), _t(v), _t(table), _t(positions))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=ATOL)


def test_write_segment_then_paged_decode_vs_jax():
    jc, tc = _configs()
    L, KVH, hs, page, T = jc.n_layers, jc.n_kv_heads, jc.head_size, 8, 19  # 3 pages
    rng = np.random.default_rng(3)
    jpool = jpc.PagePool.create(jc, n_pages=5, page_size=page)
    tpool = tpc.PagePool.create(tc, n_pages=5, page_size=page)
    table = np.asarray(tpool.alloc(tpool.pages_for(T)), np.int32)
    assert list(table) == jpool.alloc(jpool.pages_for(T))
    k_rows = rng.standard_normal((L, T, KVH, hs), dtype=np.float32)
    v_rows = rng.standard_normal((L, T, KVH, hs), dtype=np.float32)
    jpool = jpc.write_segment(jpool, jnp.asarray(k_rows), jnp.asarray(v_rows), table, 0)
    assert tpc.write_segment(tpool, _t(k_rows), _t(v_rows), table, 0) is tpool
    _assert_pools_equal(tpool, jpool)
    q = rng.standard_normal((1, 1, jc.n_heads, hs), dtype=np.float32)
    layer, pos = 1, np.asarray([T - 1], np.int32)
    want = np.asarray(jax_k14(jnp.asarray(q), jpool.k[layer], jpool.v[layer], jnp.asarray(table[None]),
                              jnp.asarray(pos)))
    got = tpa.paged_decode_attention(_t(q), tpool.k[layer], tpool.v[layer], _t(table[None]), _t(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_append_vs_jax():
    jc, tc = _configs()
    L, KVH, hs, page = jc.n_layers, jc.n_kv_heads, jc.head_size, 8
    rng = np.random.default_rng(7)
    jpool = jpc.PagePool.create(jc, n_pages=4, page_size=page)
    tpool = tpc.PagePool.create(tc, n_pages=4, page_size=page)
    tables = np.asarray([[0, 1], [2, 2]], np.int32)  # slot 0 at 7 (page 0 full), slot 1 at 2
    positions = np.asarray([7, 2])
    for b in range(2):
        T = positions[b]
        rows_k = rng.standard_normal((L, T, KVH, hs), dtype=np.float32)
        rows_v = rng.standard_normal((L, T, KVH, hs), dtype=np.float32)
        jpool = jpc.write_segment(jpool, jnp.asarray(rows_k), jnp.asarray(rows_v), tables[b], 0)
        tpc.write_segment(tpool, _t(rows_k), _t(rows_v), tables[b], 0)
    k_new = rng.standard_normal((L, 2, KVH, hs), dtype=np.float32)
    v_new = rng.standard_normal((L, 2, KVH, hs), dtype=np.float32)
    page_ids = tables[np.arange(2), positions // page].astype(np.int32)
    row_ids = (positions % page).astype(np.int32)
    jpool = jpc.append(jpool, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(page_ids),
                       jnp.asarray(row_ids))
    assert tpc.append(tpool, _t(k_new), _t(v_new), _t(page_ids), _t(row_ids)) is tpool
    _assert_pools_equal(tpool, jpool)
    for b in range(2):
        np.testing.assert_array_equal(tpool.k[0, page_ids[b], :, row_ids[b]].numpy(), k_new[0, b])


def test_append_shared_address_later_slot_wins():
    """Three slots, the first and the last on one address: the last's rows
    land there, as in the JAX scan over the slots."""
    jc, tc = _configs()
    L, KVH, hs = jc.n_layers, jc.n_kv_heads, jc.head_size
    rng = np.random.default_rng(11)
    jpool = jpc.PagePool.create(jc, n_pages=3, page_size=8)
    tpool = tpc.PagePool.create(tc, n_pages=3, page_size=8)
    k_new = rng.standard_normal((L, 3, KVH, hs), dtype=np.float32)
    v_new = rng.standard_normal((L, 3, KVH, hs), dtype=np.float32)
    page_ids, row_ids = np.asarray([0, 2, 0], np.int32), np.asarray([5, 1, 5], np.int32)
    jpool = jpc.append(jpool, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(page_ids),
                       jnp.asarray(row_ids))
    tpc.append(tpool, _t(k_new), _t(v_new), _t(page_ids), _t(row_ids))
    _assert_pools_equal(tpool, jpool)
    np.testing.assert_array_equal(tpool.k[:, 0, :, 5].numpy(), k_new[:, 2])
    np.testing.assert_array_equal(tpool.v[:, 2, :, 1].numpy(), v_new[:, 1])


def test_write_segment_table_naming_a_page_twice_later_row_wins():
    jc, tc = _configs()
    L, KVH, hs, page, T = jc.n_layers, jc.n_kv_heads, jc.head_size, 8, 13
    rng = np.random.default_rng(5)
    jpool = jpc.PagePool.create(jc, n_pages=3, page_size=page)
    tpool = tpc.PagePool.create(tc, n_pages=3, page_size=page)
    table = np.asarray([1, 1], np.int32)  # positions 0-7 and 8-12 on page 1
    k_rows = rng.standard_normal((L, T, KVH, hs), dtype=np.float32)
    v_rows = rng.standard_normal((L, T, KVH, hs), dtype=np.float32)
    jpool = jpc.write_segment(jpool, jnp.asarray(k_rows), jnp.asarray(v_rows), table, 0)
    tpc.write_segment(tpool, _t(k_rows), _t(v_rows), table, 0)
    _assert_pools_equal(tpool, jpool)
    np.testing.assert_array_equal(tpool.k[:, 1, :, 3].numpy(), k_rows[:, 11])  # position 11, not 3


def test_pool_writers_refuse_int8_pools():
    _, tc = _configs()
    pool = tpc.PagePool.create(tc, n_pages=2, page_size=8, kv_quant=True)
    rows = torch.zeros(tc.n_layers, 1, tc.n_kv_heads, tc.head_size)
    with pytest.raises(ValueError):
        tpc.write_segment(pool, rows, rows, np.asarray([0], np.int32), 0)
    with pytest.raises(ValueError):
        tpc.append(pool, rows, rows, torch.tensor([0]), torch.tensor([0]))
