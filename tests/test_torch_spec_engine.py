"""The torch port's engine-level speculative decoding against the JAX package.

On the tiny config, on the CPU (``device="cpu"``; the ``cuda`` backend's
wrappers run their plain versions on CPU tensors):

* ``_spec_drafts`` / ``_spec_commit`` equal the JAX engine's exactly on
  random histories, with BOS among the targets, budgets shorter than a
  window, inactive slots and positions at both ends of the history;
* the window form of ``paged_attention_oracle`` (B, T, H, hs) equals the JAX
  oracle, with the page count read from the positions or passed as a bound;
* ``forward`` with per-row positions and T > 1 (fp and int8 cache, a window
  running into the cache's pad) and ``paged_forward_window`` (fp and int8
  pool, a window crossing a page boundary, one running past ``seq_len``
  into the scratch page, an inactive row) equal the JAX functions: fp32 to
  1e-5, int8 to 2e-2 (the JAX model's row scales can sit one float32 ulp
  off, which moves an int8 code, as ``tests/test_torch_model_kv_quant.py``
  holds the dense int8 cache); pages the window does not reach bit-equal;
* the contracts of ``tests/test_batch_engine.py`` and
  ``tests/test_paged_engine.py`` for speculation: streams token-identical to
  the port ``Generator``'s greedy ones at ``(d, windows)`` (4, 1), (4, 4),
  (8, 2), a full-``seq_len`` stream, a mixed batch falling back to the plain
  tick, the int8 cache and pool matching their plain engines, memory
  pressure and the prefix cache;
* greedy speculative streams equal the JAX ``BatchEngine(spec_window=d)`` and
  ``PagedBatchEngine(spec_window=d)`` (``xla``, fp32) on the same checkpoint;
* on the ``cuda`` route a window calls the dequant-matmul five times a
  layer and nothing else, and a window row's hidden states are the same
  bits wherever the other rows of its batch sit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_params, tiny_config
from llama2_tpu.config import GenerationConfig as JaxGenerationConfig
from llama2_tpu.models import llama as jm
from llama2_tpu.models import paged as jpg
from llama2_tpu.ops.pallas import attention_q8 as jq8
from llama2_tpu.ops.pallas import paged_attention as jpa
from llama2_tpu.runtime import batch_engine as jbe
from llama2_tpu.runtime.paged_engine import PagedBatchEngine as JaxPagedBatchEngine
from llama2_tpu_torch.config import GenerationConfig, ModelConfig
from llama2_tpu_torch.io.checkpoint import load_checkpoint
from llama2_tpu_torch.io.convert import params_from_numpy
from llama2_tpu_torch.models import llama as tm
from llama2_tpu_torch.models import paged as tpg
from llama2_tpu_torch.ops.cuda import paged_attention as tpa
from llama2_tpu_torch.runtime import batch_engine as tbe
from llama2_tpu_torch.runtime.batch_engine import BatchEngine
from llama2_tpu_torch.runtime.generator import Generator
from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread here: beside the JAX runtime's threads, and the
    other test workers', more threads only slow these small shapes down."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

PROMPTS = [[5, 17], [], [320, 9, 44], [7], [250, 4, 99, 2, 18]]
WINDOWS = [(4, 1), (4, 4), (8, 2)]


def port_config(c) -> ModelConfig:
    return ModelConfig(**{f: getattr(c, f) for f in (
        "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size", "seq_len", "norm_eps")})


# ---------------------------------------------------------------- drafts and commits


def _window_state(rng, B: int, S: int, d: int):
    """Random per-slot histories over a small vocabulary (tokens repeat, BOS
    among them), each slot's last token at its position (one slot at 0, one
    at S - 1), budgets of 0..d + 1, about a fifth of the slots inactive, and
    targets that repeat the drafts often enough to accept some."""
    pos = rng.integers(0, S, B)
    pos[0], pos[1] = 0, S - 1
    hist = np.full((B, S), -1, np.int32)
    for b in range(B):
        hist[b, : pos[b] + 1] = rng.integers(0, 6, pos[b] + 1)
    tokens = hist[np.arange(B), pos]
    budget = rng.integers(0, d + 2, B).astype(np.int32)
    active = rng.random(B) < 0.8
    return hist, tokens.astype(np.int32), pos.astype(np.int32), budget, active


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_drafts_and_commit_equal_jax(seed, d):
    rng = np.random.default_rng(seed)
    B, S = 16, 40
    hist, tokens, pos, budget, active = _window_state(rng, B, S, d)
    active[2], budget[2] = True, d
    jseg = jbe._spec_drafts(jnp.asarray(hist), jnp.asarray(tokens), jnp.asarray(pos), d, S)
    t = [torch.from_numpy(a.astype(np.int64)) for a in (hist, tokens, pos, budget)]
    seg = tbe._spec_drafts(t[0], t[1], t[2], d, S)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))

    targets = rng.integers(0, 6, (B, d)).astype(np.int32)
    agree = rng.random((B, d - 1)) < 0.6
    targets[:, :-1] = np.where(agree, np.asarray(jseg)[:, 1:], targets[:, :-1])
    targets[2, 0] = 1  # a BOS target (slot 2 active, its budget d): emitted, so the replay retires
    jout = jbe._spec_commit(jseg, jnp.asarray(targets), jnp.asarray(hist), jnp.asarray(tokens),
                            jnp.asarray(pos), jnp.asarray(budget), jnp.asarray(active), d, S)
    tout = tbe._spec_commit(seg, torch.from_numpy(targets.astype(np.int64)), *t,
                            torch.from_numpy(active), d, S)
    for name, j, p in zip(("hist", "tokens", "pos", "budget", "active", "emitted"), jout, tout):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=name)
    assert np.asarray(jout[5])[2, 0] == 1 and not np.asarray(jout[4])[2]


# ---------------------------------------------------------------- windows


def _params(config, seed=3):
    p = random_params(config, seed=seed)
    return {k: jnp.asarray(v) for k, v in p.items()}, params_from_numpy(p, "cpu", torch.float32)


def test_paged_oracle_window_equals_jax():
    """Windows of T = 3 crossing a page boundary (row 0), running past the
    table's reach (row 1: clamped to its width) and on the scratch page (row
    2); the page count read from ``pos`` or passed as a larger bound."""
    rng = np.random.default_rng(5)
    P, KVH, page, hs, H, B, T, W = 10, 2, 8, 16, 4, 3, 3, 4
    k = rng.standard_normal((P, KVH, page, hs)).astype(np.float32)
    v = rng.standard_normal((P, KVH, page, hs)).astype(np.float32)
    table = np.zeros((B, W), np.int32)
    table[0, :3], table[1] = [4, 7, 2], [9, 3, 6, 1]
    pos = np.asarray([6, 4 * page - 2, 3], np.int32)
    q = rng.standard_normal((B, T, H, hs)).astype(np.float32)
    want = np.asarray(jpa.paged_attention_oracle(*map(jnp.asarray, (q, k, v, table, pos))))
    args = [torch.from_numpy(a) for a in (q, k, v, table, pos)]
    assert tpa._pages_read(args[4], page, T, W) == W
    np.testing.assert_allclose(tpa.paged_attention_oracle(*args).numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tpa.paged_attention_oracle(*args, n_pages=W).numpy(), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_forward_per_row_window_equals_jax(kv_quant):
    """Three rows, T = 4, at positions 5, 40 and seq_len - 2 (its last two
    rows in the cache's pad) over a cache holding random earlier rows."""
    c = tiny_config()
    config = port_config(c)
    jp, tp = _params(c)
    rng = np.random.default_rng(7)
    B, T, pad = 3, 4, 4
    shape = (c.n_layers, B, c.n_kv_heads, c.seq_len + pad, c.head_size)
    k = rng.standard_normal(shape).astype(np.float32) * 0.5
    v = rng.standard_normal(shape).astype(np.float32) * 0.5
    if kv_quant:
        cache = dict(zip(("k", "k_scale"), map(np.asarray, jq8.quantize_kv_rows(jnp.asarray(k)))))
        cache.update(zip(("v", "v_scale"), map(np.asarray, jq8.quantize_kv_rows(jnp.asarray(v)))))
    else:
        cache = {"k": k, "v": v}
    tokens = rng.integers(2, c.vocab_size, (B, T)).astype(np.int32)
    pos = np.asarray([5, 40, c.seq_len - 2], np.int32)
    jh, jcache = jm.forward(jp, {n: jnp.asarray(a) for n, a in cache.items()}, jnp.asarray(tokens),
                            jnp.asarray(pos), c)
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    th = tm.forward(tp, tcache, torch.from_numpy(tokens), torch.from_numpy(pos), config, "torch")
    tol = 2e-2 if kv_quant else 1e-5
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=tol, atol=tol)
    for n in ("k", "v"):
        got, want = tcache[n].float().numpy(), np.asarray(jcache[n]).astype(np.float32)
        if kv_quant:  # one int8 step where a row scale sits an ulp off
            assert np.abs(got - want).max() <= 1
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_forward_window_past_an_unpadded_cache_raises():
    c = tiny_config()
    config = port_config(c)
    _, tp = _params(c)
    cache = tm.init_cache(config, 2)
    tokens = torch.full((2, 4), 5)
    with pytest.raises(ValueError, match="padded"):
        tm.forward(tp, cache, tokens, torch.tensor([3, c.seq_len - 2]), config, "torch")
    tm.forward(tp, tm.init_cache(config, 2, pad=4), tokens, torch.tensor([3, c.seq_len - 2]),
               config, "torch")


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_forward_window_equals_jax(kv_quant):
    """Pages of 8 rows, T = 4: row 0 at 6 crosses into its second page, row 1
    at seq_len - 2 runs two rows past seq_len (the scratch page), row 2 is
    inactive (an all-zero table row). Hidden states and every page but the
    scratch page against JAX's window."""
    c = tiny_config()
    config = port_config(c)
    jp, tp = _params(c)
    rng = np.random.default_rng(9)
    page, P, B, T = 8, 20, 3, 4
    W = c.seq_len // page
    shape = (c.n_layers, P, c.n_kv_heads, page, c.head_size)
    k = rng.standard_normal(shape).astype(np.float32) * 0.5
    v = rng.standard_normal(shape).astype(np.float32) * 0.5
    if kv_quant:
        pools = [np.asarray(a) for a in (*jq8.quantize_kv_rows(jnp.asarray(k)),
                                         *jq8.quantize_kv_rows(jnp.asarray(v)))]
    else:
        pools = [k, v]
    table = np.zeros((B, W), np.int32)
    order = rng.permutation(np.arange(1, P))
    table[0, :2], table[1, :W - 7] = order[:2], order[2:W - 5]
    table[1, W - 7:] = order[:7]  # row 1's last pages: shared, as a table may name any page
    pos = np.asarray([6, c.seq_len - 2, 5], np.int32)
    seg = rng.integers(2, c.vocab_size, (B, T)).astype(np.int32)
    jpools = [jnp.asarray(a) for a in pools]
    if kv_quant:
        res = jpg.paged_forward_window(jp, jpools[0], jpools[2], jnp.asarray(table), jnp.asarray(seg),
                                       jnp.asarray(pos), c, ks_pool=jpools[1], vs_pool=jpools[3])
        jh, jout = res[0], [res[1], res[2], res[3], res[4]]
    else:
        res = jpg.paged_forward_window(jp, *jpools, jnp.asarray(table), jnp.asarray(seg),
                                       jnp.asarray(pos), c)
        jh, jout = res[0], [res[1], res[2]]
    tpools = [torch.from_numpy(a.copy()) for a in pools]
    kv = (tpools[0], tpools[2]) if kv_quant else tuple(tpools)
    scales = dict(ks_pool=tpools[1], vs_pool=tpools[3]) if kv_quant else {}
    out = tpg.paged_forward_window(tp, *kv, torch.from_numpy(table), torch.from_numpy(seg),
                                   torch.from_numpy(pos), config, "torch", **scales)
    assert len(out) == len(pools) + 1
    tol = 2e-2 if kv_quant else 1e-5
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jh), rtol=tol, atol=tol)
    for t, j in zip(tpools, jout):
        got, want = t[:, 1:].float().numpy(), np.asarray(j)[:, 1:].astype(np.float32)
        if kv_quant:
            assert np.abs(got - want).max() <= (1 if t.dtype == torch.int8 else 1e-5)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the window's rows past seq_len landed on the scratch page only
    touched = [int(table[1, (c.seq_len - 2) // page])]
    untouched = [p for p in range(1, P) if p not in set(table[:2].ravel()) | set(touched)]
    for t, a in zip(tpools, pools):
        np.testing.assert_array_equal(t[:, untouched].numpy(), a[:, untouched])


# ---------------------------------------------------------------- engines


@pytest.fixture(scope="module")
def setup(tiny_checkpoint):
    path, jconfig, jparams = tiny_checkpoint
    config, params, _ = load_checkpoint(path)
    ref = Generator(config, params, backend="torch", device="cpu")
    return config, params, ref, jconfig, jparams


def make(kind: str, config, params, **kw):
    kw.setdefault("backend", "torch")
    if kind == "paged":
        kw.setdefault("page_size", 8)
        kw.setdefault("n_pages", 24)
        return PagedBatchEngine(config, params, device="cpu", **kw)
    return BatchEngine(config, params, device="cpu", **kw)


def serve(eng, prompts, gen, max_ticks=100_000):
    queues = [eng.submit(p, gen) for p in prompts]
    eng.run_until_idle(max_ticks=max_ticks)
    out = [q.get(timeout=120) for q in queues]
    for r in out:
        assert not isinstance(r, Exception), r
    return [r.tokens for r in out]


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("d,windows", WINDOWS)
def test_spec_streams_token_identical(setup, kind, d, windows):
    """Speculative windows emit exactly the plain greedy streams across slot
    reuse and varied lengths (paged: pages of 8 < d * windows force growth
    inside a tick), and every page comes back."""
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=23)
    want = [ref.generate(p, gen).tokens for p in PROMPTS]
    eng = make(kind, config, params, batch_size=2, spec_window=d, ticks_per_sync=windows)
    assert serve(eng, PROMPTS, gen) == want
    assert eng.metrics["spec_windows"] > 0
    if kind == "paged":
        assert all(not p for p in eng._slot_pages)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_full_seq_len(setup, kind):
    """steps = seq_len: windows run past seq_len, into the cache's pad or the
    scratch page, without touching committed rows."""
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=0)
    want = ref.generate([9, 4], gen).tokens
    kw = dict(n_pages=2 * (config.seq_len // 8) + 4) if kind == "paged" else {}
    eng = make(kind, config, params, batch_size=2, spec_window=4, ticks_per_sync=8, **kw)
    assert serve(eng, [[9, 4]], gen) == [want]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_mixed_batch_falls_back(setup, kind):
    """A sampled request routes the tick through the plain one; the greedy
    stream stays exact and the sampled one equals its stream on an engine
    without speculation."""
    config, params, ref, _, _ = setup
    g_greedy = GenerationConfig(temperature=0.0, steps=16)
    g_sampled = GenerationConfig(temperature=0.9, top_p=0.9, steps=16, seed=3)
    want = ref.generate([5, 17], g_greedy).tokens

    def run(**kw):
        eng = make(kind, config, params, batch_size=2, **kw)
        q1, q2 = eng.submit([5, 17], g_greedy), eng.submit([7], g_sampled)
        eng.run_until_idle()
        return q1.get(timeout=60).tokens, q2.get(timeout=60).tokens

    greedy, sampled = run(spec_window=4)
    assert greedy == want and sampled == run()[1]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_int8_kv_matches_plain(setup, kind):
    """Over the int8 cache (dense) or pool (paged): the committed rows
    quantize the values a plain tick writes, so streams equal the plain int8
    engine's."""
    config, params, _, _, _ = setup
    prompts = [[5, 17], [320, 9, 44], [7]]
    gen = GenerationConfig(temperature=0.0, steps=18)

    def run(**kw):
        return serve(make(kind, config, params, batch_size=2, kv_quant=True, **kw), prompts, gen)

    assert run(spec_window=4, ticks_per_sync=2) == run()


def test_paged_spec_memory_pressure(setup):
    """Window-span page growth in a tiny pool preempts and recomputes; every
    stream still completes exactly."""
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=12)
    prompts = [[4, 8, 15], [16, 23], [42]]
    want = [ref.generate(p, gen).tokens for p in prompts]
    eng = make("paged", config, params, batch_size=3, n_pages=6, spec_window=4, ticks_per_sync=2)
    assert serve(eng, prompts, gen, max_ticks=2000) == want


def test_paged_spec_with_prefix_cache(setup):
    """Prefix sharing composes with the windows: identical prompts reuse
    cached pages and still emit the exact greedy stream."""
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=34)
    prompt = list(range(2, 22))  # more than two full pages of 8
    want = ref.generate(prompt, gen).tokens
    eng = make("paged", config, params, batch_size=2, n_pages=32, spec_window=4, ticks_per_sync=2,
               prefix_cache=True)
    assert serve(eng, [prompt, prompt], gen) == [want, want]
    assert eng.metrics["prefix_hit_pages"] > 0


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_streams_equal_the_jax_engines(setup, kind):
    """The port's and the JAX package's speculative engines (``xla``, fp32)
    on the same checkpoint: token-identical greedy streams."""
    config, params, _, jconfig, jparams = setup
    prompts = PROMPTS + [[11, 12, 13]]
    kw = dict(batch_size=2, spec_window=4, ticks_per_sync=2)
    if kind == "paged":
        jeng = JaxPagedBatchEngine(jconfig, jparams, page_size=8, n_pages=24, **kw)
    else:
        jeng = jbe.BatchEngine(jconfig, jparams, **kw)
    jq = [jeng.submit(p, JaxGenerationConfig(temperature=0.0, steps=20)) for p in prompts]
    jeng.run_until_idle()
    want = [q.get(timeout=300).tokens for q in jq]
    assert serve(make(kind, config, params, **kw), prompts, GenerationConfig(temperature=0.0, steps=20)) == want


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_on_the_cuda_backend_plain_versions(setup, kind):
    """``backend="cuda"`` on CPU tensors (every wrapper's plain version, the
    window's projections and attention as on the card): the same greedy
    streams as the plain tick of the same engine."""
    config, params, _, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=20)
    plain = serve(make(kind, config, params, batch_size=2, backend="cuda"), PROMPTS, gen)
    assert serve(make(kind, config, params, batch_size=2, backend="cuda", spec_window=4), PROMPTS, gen) == plain


# ---------------------------------------------------------------- the window's launches


def _counting(monkeypatch, module, names, calls):
    for name in names:
        orig = getattr(module, name)

        def wrapper(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(module, name, wrapper)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_window_calls_on_the_cuda_backend(monkeypatch, kind):
    """INT8 weights fused for ``cuda`` at dim 256 (head size 128, where the
    decode step takes the two-launch route): a window of 2 rows x 4 tokens
    calls, a layer, five dequant-matmuls (dense: the prefill segment's
    projections; paged: the rmsnorm-fused QKV, then the segment's wo, w1, w3
    and w2), and one classifier call; no decode attention kernel and no
    megakernel, as ``chip_smoke.py``'s SPEC_WINDOWS asserts on the card. Its
    hidden states agree with the ``torch`` backend's to fast mode's 2e-2."""
    from test_torch_paged import WIDE, _trees

    from llama2_tpu_torch.ops import linear as tlin
    from llama2_tpu_torch.runtime.paged_cache import PagePool

    _, tp = _trees(WIDE, True, "xla", "cuda", seed=13)
    _, tref = _trees(WIDE, True, "xla", "torch", seed=13)
    config, L = port_config(WIDE), WIDE.n_layers
    decode = ("paged_decode_attention_q8_fused", "paged_decode_attention_fused",
              "paged_decode_attention_q8_stacked", "paged_decode_attention_stacked")
    counts = {}
    for module, names in ((tpg, decode + ("quant_matmul_stacked",)),
                          (tm, ("layer_tail_qkv_stacked", "attn_mlp_block_stacked", "mlp_block_stacked",
                                "flash_decode_attention_q8", "flash_prefill_attention",
                                "flash_decode_attention_fused")),
                          (tlin, ("quant_matmul", "quant_matmul_stacked"))):
        mod_calls = dict.fromkeys(names, 0)
        _counting(monkeypatch, module, names, mod_calls)
        counts[module.__name__.split(".")[-1]] = mod_calls
    rng = np.random.default_rng(2)
    B, T = 2, 4
    seg = torch.from_numpy(rng.integers(2, WIDE.vocab_size, (B, T)))
    pos = torch.tensor([3, 70])

    def window(params, backend):
        if kind == "dense":
            cache = tm.init_cache(config, B, pad=T)
            hidden = tm.forward(params, cache, seg, pos, config, backend)
        else:
            pool = PagePool.create(config, 8, 64)
            table = torch.tensor([[1, 2, 0, 0], [3, 4, 5, 0]], dtype=torch.int32)
            hidden = tpg.paged_forward_window(params, pool.k, pool.v, table, seg, pos, config, backend)[0]
        return tm.logits_from_hidden(params, hidden, backend)

    got = window(tp, "cuda")
    flat = {f"{m}.{n}": v for m, c in counts.items() for n, v in c.items()}
    want = dict.fromkeys(flat, 0)
    if kind == "dense":
        want.update({"linear.quant_matmul_stacked": 5 * L, "linear.quant_matmul": 1})
    else:
        want.update({"paged.quant_matmul_stacked": L, "linear.quant_matmul_stacked": 4 * L,
                     "linear.quant_matmul": 1})
    assert flat == want
    np.testing.assert_allclose(got.numpy(), window(tref, "torch").numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_window_row_does_not_depend_on_the_batch(kind, kv_quant):
    """A window row's hidden states are the same bits wherever the row
    batched with it sits: the window attends over the whole cache (dense) or
    every entry of the table (paged), so no shape follows the batch's
    longest row. Caches and pools hold random earlier rows."""
    from llama2_tpu_torch.runtime.paged_cache import PagePool

    c = tiny_config()
    config = port_config(c)
    _, tp = _params(c, seed=4)
    T, page = 4, 8
    W = config.seq_len // page
    seg = torch.from_numpy(np.random.default_rng(11).integers(2, c.vocab_size, (2, T)))
    table = torch.arange(1, 2 * W + 1, dtype=torch.int32).reshape(2, W)
    outs = []
    for far in (9, config.seq_len - T):
        g = torch.Generator().manual_seed(5)
        if kind == "dense":
            cache = tm.init_cache(config, 2, kv_quant=kv_quant, pad=T)
            store = cache.values()
        else:
            pool = PagePool.create(config, 2 * W + 1, page, kv_quant=kv_quant)
            store = pool.tensors
        for t in store:
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g, dtype=torch.int8))
            elif kv_quant:  # the scales
                t.copy_(0.01 + 0.02 * torch.rand(t.shape, generator=g))
            else:
                t.copy_(torch.randn(t.shape, generator=g))
        pos = torch.tensor([3, far])
        if kind == "dense":
            hidden = tm.forward(tp, cache, seg, pos, config, "torch")
        else:
            hidden = tpg.paged_forward_window(tp, pool.k, pool.v, table, seg, pos, config, "torch",
                                              pool.ks, pool.vs)[0]
        outs.append(hidden[0])
    assert torch.equal(outs[0], outs[1])
