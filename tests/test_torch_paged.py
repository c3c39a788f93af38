"""The torch port's paged KV cache and paged decode step against the JAX package.

* ``PagePool`` / ``PrefixCache`` / ``_bucket`` bookkeeping: the contracts of
  ``tests/test_paged.py`` that are not TPU rules (allocation and release,
  writes through the table then attention equal to a dense cache, appends at
  (page, row), int8 pool shapes), and the prefix cache's refcounts and LRU.
* ``paged_forward_step`` against JAX's on the same pools, tables and weights
  for three steps of three rows (one crossing a page boundary, one inactive
  on the scratch page), every route: ``torch`` <-> ``xla`` and
  ``cuda-accurate`` <-> ``pallas-accurate`` to 1e-4 over fp pools, ``cuda``
  <-> ``pallas`` to 2e-2 (fast mode rounds matmul operands to bf16); over
  int8 pools 2e-2 for every pair, as ``tests/test_torch_model_kv_quant.py``
  holds the dense int8 cache (the compiled JAX model's row scales can sit one
  float32 ulp off, which moves an int8 code). At dim 256 and head size 128
  the fast backend takes the two-launch route, with the calls per step
  counted: K6 1, K17 or K18 L, K12 L - 1, K11 1, then K5 1 for the
  classifier; elsewhere the composed route calls K15 or K16 once a layer.
* A paged step's hidden states equal the dense ``forward``'s on the same rows
  (fp32, 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from llama2_tpu.config import ModelConfig
from llama2_tpu.models import llama as jm
from llama2_tpu.models import paged as jpg
from llama2_tpu.ops.pallas import attention_q8 as jq8
from llama2_tpu.quant import q8 as jq
from llama2_tpu_torch.config import ModelConfig as TorchModelConfig
from llama2_tpu_torch.io.convert import params_from_numpy
from llama2_tpu_torch.models import llama as tm
from llama2_tpu_torch.models import paged as tpg
from llama2_tpu_torch.ops import linear as tlin
from llama2_tpu_torch.ops import ref
from llama2_tpu_torch.ops.cuda import paged_attention as tpa
from llama2_tpu_torch.quant import q8 as tq
from llama2_tpu_torch.runtime.paged_cache import OutOfPages, PagePool, PrefixCache, _bucket, write_pages


def port_config(c: ModelConfig) -> TorchModelConfig:
    return TorchModelConfig(**{f: getattr(c, f) for f in (
        "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size", "seq_len", "norm_eps")})


# ---------------------------------------------------------------- bookkeeping


def test_pool_alloc_release_exhaustion():
    config = port_config(tiny_config())
    pool = PagePool.create(config, n_pages=4, page_size=8)
    a = pool.alloc(3)
    assert len(set(a)) == 3
    with pytest.raises(OutOfPages):
        pool.alloc(2)
    pool.release(a[:2])
    b = pool.alloc(3)
    assert len(set(b)) == 3
    assert pool.pages_for(1) == 1 and pool.pages_for(8) == 1
    assert pool.pages_for(9) == 2 and pool.pages_for(0) == 1


def test_pagepool_shapes_match_jax_and_int8_is_a_quarter():
    from llama2_tpu.runtime.paged_cache import PagePool as JPagePool

    c = tiny_config()
    config = port_config(c)
    fp = PagePool.create(config, n_pages=4, page_size=8)
    q8 = PagePool.create(config, n_pages=4, page_size=8, kv_quant=True)
    assert q8.kv_quant and not fp.kv_quant
    assert q8.k.dtype == torch.int8 and q8.ks.dtype == torch.float32
    assert q8.ks.shape == q8.k.shape[:-1]
    assert q8.k.nbytes * 4 == fp.k.nbytes
    j = JPagePool.create(c, n_pages=4, page_size=8, kv_quant=True)
    assert tuple(j.k.shape) == tuple(q8.k.shape) and tuple(j.ks.shape) == tuple(q8.ks.shape)
    assert fp.tensors == (fp.k, fp.v) and q8.tensors == (q8.k, q8.ks, q8.v, q8.vs)
    assert fp.free == list(range(3, -1, -1))  # pops page 0 last, as JAX's


def test_write_pages_then_attention_matches_dense_cache():
    """Prefill rows written through the table == the dense cache path."""
    config = port_config(tiny_config())
    L, KVH, hs, H = config.n_layers, config.n_kv_heads, config.head_size, config.n_heads
    page, T = 8, 19  # spans 3 pages
    rng = np.random.default_rng(3)
    pool = PagePool.create(config, n_pages=5, page_size=page)
    table = np.asarray(pool.alloc(pool.pages_for(T)), np.int64)
    k_rows = torch.from_numpy(rng.standard_normal((T, L, KVH, hs)).astype(np.float32))
    v_rows = torch.from_numpy(rng.standard_normal((T, L, KVH, hs)).astype(np.float32))
    logical = np.arange(T)
    pids, rids = torch.as_tensor(table[logical // page]), torch.as_tensor(logical % page)
    write_pages(pool.k, k_rows, pids, rids)
    write_pages(pool.v, v_rows, pids, rids)
    q = torch.from_numpy(rng.standard_normal((1, 1, H, hs)).astype(np.float32))
    layer = 1
    pos = torch.tensor([T - 1], dtype=torch.int32)
    got = tpa.paged_attention_oracle(q, pool.k[layer], pool.v[layer],
                                     torch.as_tensor(table[None].astype(np.int32)), pos)
    k_dense = torch.zeros(1, KVH, 3 * page, hs)
    v_dense = torch.zeros(1, KVH, 3 * page, hs)
    k_dense[0, :, :T] = k_rows[:, layer].transpose(0, 1)
    v_dense[0, :, :T] = v_rows[:, layer].transpose(0, 1)
    want = ref.attention(q, k_dense, v_dense, T - 1)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_decode_rows_land_at_page_and_row():
    config = port_config(tiny_config())
    L, KVH, hs = config.n_layers, config.n_kv_heads, config.head_size
    pool = PagePool.create(config, n_pages=4, page_size=8)
    rng = np.random.default_rng(7)
    tables = np.asarray([[0, 1], [2, 2]], np.int32)
    positions = np.asarray([7, 2])
    page_ids = torch.as_tensor(tables[np.arange(2), positions // 8])
    row_ids = torch.as_tensor(positions % 8)
    new = torch.from_numpy(rng.standard_normal((2, KVH, hs)).astype(np.float32))
    for layer in range(L):
        tpa.write_rows((pool.k,), (new + layer,), layer, page_ids, row_ids)
    for b in range(2):
        for layer in range(L):
            assert torch.equal(pool.k[layer, page_ids[b], :, row_ids[b]], new[b] + layer)
    assert int((pool.k != 0).any(-1).sum()) == 2 * L * KVH  # nothing else written


def test_prefix_cache_refcounts_and_lru():
    pc = PrefixCache()
    assert pc.lookup(b"a") is None and pc.misses == 1
    assert pc.register(b"a", 5) and pc.register(b"b", 6)
    assert not pc.register(b"a", 7) and not pc.register(b"c", 5)  # key or page taken
    assert pc.lookup(b"a") == 5 and pc.refs[5] == 2 and pc.hits == 1
    assert pc.release(5) and pc.release(5)  # cached: the caller must not free it
    assert not pc.release(9)  # not a cached page: the caller frees it
    assert pc.evictable == 1
    assert pc.release(6) and pc.evictable == 2
    assert pc.lookup(b"b") == 6 and pc.evictable == 1  # a hit takes it off the LRU
    assert pc.evict(5) == [5] and b"a" not in pc.key2page and 5 not in pc.refs
    pc.release(6)
    assert pc.evict(1) == [6] and pc.evictable == 0
    pc.register(b"z", 1)
    pc.clear()
    assert not (pc.key2page or pc.page2key or pc.refs or pc.evictable)


def test_bucket_is_jax_bucket():
    from llama2_tpu.runtime.paged_cache import _bucket as jbucket

    for T in (1, 31, 32, 33, 100, 128, 129, 600, 4096):
        assert _bucket(T) == jbucket(T)


# ---------------------------------------------------------------- the step


def _fp_params(config: ModelConfig, seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.standard_normal(s, np.float32) * 0.05

    L, D, HD, V, KV = config.n_layers, config.dim, config.hidden_dim, config.vocab_size, config.kv_dim
    return {
        "tok_emb": r(V, D), "rms_att": 1 + r(L, D), "wq": r(L, D, D),
        "wk": r(L, D, KV), "wv": r(L, D, KV), "wo": r(L, D, D),
        "rms_ffn": 1 + r(L, D), "w1": r(L, D, HD), "w2": r(L, HD, D),
        "w3": r(L, D, HD), "rms_final": 1 + r(D), "wcls": r(D, V),
    }


def _trees(config: ModelConfig, quant: bool, jbackend: str, tbackend: str, seed: int = 11):
    """The same params for each package, quantized (group 16 at dim 64, 64 at
    dim 256) and fused for the backend as the engines fuse them."""
    params = _fp_params(config, seed)
    if not quant:
        return ({k: jnp.asarray(v) for k, v in params.items()},
                params_from_numpy(params, "cpu", torch.float32))
    tree = dict(params)
    for k, t in tq.quantize_params(params, 64 if config.dim % 128 == 0 else 16).items():
        if isinstance(t, tq.QuantTensor):
            tree[k] = (t.q.numpy(), t.scale.numpy(), t.group_size)
    jp = {k: jq.QuantTensor(q=jnp.asarray(v[0]), scale=jnp.asarray(v[1]), group_size=v[2])
          if isinstance(v, tuple) else jnp.asarray(v) for k, v in tree.items()}
    tp = params_from_numpy(tree, "cpu", torch.float32)
    if jbackend.startswith("pallas"):
        jp = jm.fuse_layer_params(jp, jbackend)
    if tbackend.startswith("cuda"):
        tp = tm.fuse_layer_params(tp, tbackend)
    return jp, tp


def _pools(config: ModelConfig, page: int, kv_quant: bool, rng):
    """Random pool contents (as if prefilled), numpy, in the kernels' order."""
    P = 12
    shape = (config.n_layers, P, config.n_kv_heads, page, config.head_size)
    k = rng.standard_normal(shape).astype(np.float32) * 0.5
    v = rng.standard_normal(shape).astype(np.float32) * 0.5
    if not kv_quant:
        return (k, v)
    k8, ks = jq8.quantize_kv_rows(jnp.asarray(k))
    v8, vs = jq8.quantize_kv_rows(jnp.asarray(v))
    return tuple(np.asarray(a) for a in (k8, ks, v8, vs))


def run_steps(config: ModelConfig, jp, tp, jbackend, tbackend, page, kv_quant, steps=3, seed=0):
    """``steps`` decode steps of three rows through both ``paged_forward_step``s:
    row 0 crosses a page boundary, row 1 sits mid-page, row 2 is inactive (an
    all-zero table row: the scratch page). Both take the JAX side's greedy
    tokens. Returns the per-step (JAX, port) logits and final pools."""
    rng = np.random.default_rng(seed)
    pools = _pools(config, page, kv_quant, rng)
    max_pages = -(-config.seq_len // page)
    table = np.zeros((3, max_pages), np.int32)
    order = rng.permutation(np.arange(1, 12))  # pages handed out shuffled
    n0 = min(3, max_pages)
    table[0, :n0], table[1, :2] = order[:n0], order[3:5]
    pos = np.asarray([page - 2, page // 2 + 1, 5], np.int32)
    tokens = rng.integers(2, config.vocab_size, 3).astype(np.int32)
    jpools = [jnp.asarray(a) for a in pools]
    tpools = [torch.from_numpy(a.copy()) for a in pools]
    out = []
    for _ in range(steps):
        page_ids = table[np.arange(3), pos // page].astype(np.int32)
        row_ids = (pos % page).astype(np.int32)
        args = [jnp.asarray(a) for a in (table, tokens, pos, page_ids, row_ids)]
        scales = dict(ks_pool=jpools[1], vs_pool=jpools[3]) if kv_quant else {}
        kv = (jpools[0], jpools[2]) if kv_quant else tuple(jpools)
        res = jpg.paged_forward_step(jp, *kv, *args, config, backend=jbackend, **scales)
        jh = res[0]
        jpools = [res[1], res[2], res[3], res[4]] if kv_quant else [res[1], res[2]]
        jl = np.asarray(jm.logits_from_hidden(jp, jh[:, -1, :], backend=jbackend))
        targs = [torch.from_numpy(a) for a in (table, tokens, pos, page_ids, row_ids)]
        tscales = dict(ks_pool=tpools[1], vs_pool=tpools[3]) if kv_quant else {}
        tkv = (tpools[0], tpools[2]) if kv_quant else tuple(tpools)
        th = tpg.paged_forward_step(tp, *tkv, *targs, port_config(config), tbackend, **tscales)[0]
        tl = tm.logits_from_hidden(tp, th[:, -1, :], tbackend).numpy()
        out.append((jl, tl))
        tokens = jl.argmax(-1).astype(np.int32)
        pos = pos + np.asarray([1, 1, 0], np.int32)  # the inactive row stays frozen
    return out, jpools, tpools


TINY = ModelConfig(dim=64, hidden_dim=172, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=256,
                   seq_len=256, norm_eps=1e-5)
# dim 256, head size 128: the fast backend's two-launch route engages
WIDE = ModelConfig(dim=256, hidden_dim=384, n_layers=2, n_heads=2, n_kv_heads=2, vocab_size=128,
                   seq_len=256, norm_eps=1e-5)

# (quantized weights, JAX backend, port backend, tolerance of fp pools)
PAIRS = [
    (False, "xla", "torch", 1e-4),
    (False, "pallas", "cuda", 1e-4),
    (True, "xla", "torch", 1e-4),
    (True, "pallas-accurate", "cuda-accurate", 1e-4),
    (True, "pallas", "cuda", 2e-2),
]


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("quant,jbackend,tbackend,tol", PAIRS)
def test_paged_step_matches_jax(quant, jbackend, tbackend, tol, kv_quant):
    """Every route of the composed and glue-fused layer (TINY: head size 16,
    GQA). The JAX int8 kernels need pages of 128 rows; the fp pools run 16."""
    page = 128 if kv_quant else 16
    jp, tp = _trees(TINY, quant, jbackend, tbackend)
    out, jpools, tpools = run_steps(TINY, jp, tp, jbackend, tbackend, page, kv_quant)
    tol = 2e-2 if kv_quant else tol
    for jl, tl in out:
        np.testing.assert_allclose(tl, jl, atol=tol, rtol=tol)
    if not kv_quant:  # the rows each step wrote agree as the logits do
        for j, t in zip(jpools, tpools):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=tol)


def _count(monkeypatch, module, names, calls):
    for name in names:
        orig = getattr(module, name)

        def wrapper(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(module, name, wrapper)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_two_launch_route_calls_and_parity(monkeypatch, kv_quant):
    """WIDE, INT8 weights, ``cuda`` <-> ``pallas``: per step one K6 (layer 0's
    QKV), K17 (fp pool) or K18 (int8 pool) a layer, K12 for all but the last
    layer, K11 for the last, and K5 for the classifier; no stacked paged
    attention."""
    jp, tp = _trees(WIDE, True, "pallas", "cuda", seed=13)
    calls = {}
    attn = ("paged_decode_attention_q8_fused", "paged_decode_attention_fused",
            "paged_decode_attention_q8_stacked", "paged_decode_attention_stacked")
    calls.update(dict.fromkeys(attn, 0))
    _count(monkeypatch, tpg, attn, calls)
    tail = ("quant_matmul_stacked", "layer_tail_qkv_stacked", "attn_mlp_block_stacked")
    calls.update(dict.fromkeys(tail, 0))
    _count(monkeypatch, tm, tail, calls)
    calls["quant_matmul"] = 0
    _count(monkeypatch, tlin, ("quant_matmul",), calls)
    steps, L = 3, WIDE.n_layers
    out, _, _ = run_steps(WIDE, jp, tp, "pallas", "cuda", 128, kv_quant, steps=steps)
    for jl, tl in out:
        np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=2e-2)
    fused = "paged_decode_attention_q8_fused" if kv_quant else "paged_decode_attention_fused"
    want = dict.fromkeys(calls, 0)
    want.update({"quant_matmul_stacked": 1, fused: L, "layer_tail_qkv_stacked": L - 1,
                 "attn_mlp_block_stacked": 1, "quant_matmul": 1})
    assert calls == {k: steps * v for k, v in want.items()}


@pytest.mark.parametrize("kv_quant", [False, True])
def test_composed_route_calls(monkeypatch, kv_quant):
    """``cuda-accurate`` (and fp weights on ``cuda``): one stacked paged
    attention (K15 or K16) a layer per step, no glue-fused one."""
    attn = ("paged_decode_attention_q8_fused", "paged_decode_attention_fused",
            "paged_decode_attention_q8_stacked", "paged_decode_attention_stacked")
    for quant, backend in ((True, "cuda-accurate"), (False, "cuda")):
        calls = dict.fromkeys(attn, 0)
        with monkeypatch.context() as m:
            _count(m, tpg, attn, calls)
            _, tp = _trees(TINY, quant, "xla", backend)
            cfg = port_config(TINY)
            pools = PagePool.create(cfg, 6, 16, kv_quant=kv_quant).tensors
            kv = (pools[0], pools[2]) if kv_quant else pools
            scales = dict(ks_pool=pools[1], vs_pool=pools[3]) if kv_quant else {}
            z = torch.zeros(2, dtype=torch.int32)
            tpg.paged_forward_step(tp, *kv, torch.ones(2, 16, dtype=torch.int32), z + 3, z + 4, z + 1,
                                   z + 4, cfg, backend, **scales)
        stacked = "paged_decode_attention_q8_stacked" if kv_quant else "paged_decode_attention_stacked"
        assert calls == {**dict.fromkeys(attn, 0), stacked: TINY.n_layers}, (backend, calls)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_paged_step_equals_dense_forward(backend):
    """The same K/V rows in pages and in a dense cache give the same hidden
    states from one decode step (fp32 pools, the rows of each position
    written to both)."""
    config = port_config(TINY)
    _, tp = _trees(TINY, False, "xla", backend)
    rng = np.random.default_rng(21)
    page, B, L, KVH, hs = 16, 2, config.n_layers, config.n_kv_heads, config.head_size
    pos = np.asarray([37, 16], np.int32)
    pool = PagePool.create(config, 10, page)
    table = np.zeros((B, -(-config.seq_len // page)), np.int32)
    table[0, :3], table[1, :2] = [7, 2, 9], [4, 1]
    cache = tm.init_cache(config, B, torch.float32, "cpu")
    for b in range(B):
        rows = torch.from_numpy(rng.standard_normal((2, int(pos[b]), L, KVH, hs)).astype(np.float32))
        t = np.arange(pos[b])
        pids, rids = torch.as_tensor(table[b, t // page]), torch.as_tensor(t % page)
        write_pages(pool.k, rows[0], pids, rids)
        write_pages(pool.v, rows[1], pids, rids)
        cache["k"][:, b, :, : pos[b]] = rows[0].permute(1, 2, 0, 3)
        cache["v"][:, b, :, : pos[b]] = rows[1].permute(1, 2, 0, 3)
    tokens = torch.tensor([5, 9], dtype=torch.int32)
    tpos = torch.from_numpy(pos)
    hp = tpg.paged_forward_step(tp, pool.k, pool.v, torch.from_numpy(table), tokens, tpos,
                                torch.from_numpy(table[np.arange(B), pos // page]),
                                torch.from_numpy(pos % page), config, backend)[0]
    hd = tm.forward(tp, cache, tokens[:, None].long(), tpos, config, backend)
    torch.testing.assert_close(hp, hd, atol=1e-5, rtol=1e-5)
