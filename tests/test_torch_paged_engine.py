"""The torch port's paged continuous-batching engine: token-identical to the
dense engine, the single stream and the JAX paged engine; page accounting
under reuse; behaviour under memory pressure; the prefix cache.

The non-speculative contracts of ``tests/test_paged_engine.py`` (the
speculative ones are in ``tests/test_torch_spec_engine.py``; and the
engine-level ones of ``tests/test_paged.py``), on the tiny checkpoint and the
CPU (``device="cpu"``; the ``cuda`` backend's wrappers run their plain
versions on CPU tensors), plus:

* greedy streams token-identical to the JAX ``PagedBatchEngine`` (``xla``,
  fp32) over an fp and an int8 pool;
* the staging window of a prefix hit whose suffix is longer than 128 tokens
  (the JAX engine's fault C3): token-identical to a cold run.
"""

import queue

import numpy as np
import pytest
import torch

from conftest import random_params
from llama2_tpu.config import GenerationConfig as JaxGenerationConfig
from llama2_tpu.config import ModelConfig as JaxModelConfig
from llama2_tpu.runtime.paged_engine import PagedBatchEngine as JaxPagedBatchEngine
from llama2_tpu_torch.config import GenerationConfig, ModelConfig
from llama2_tpu_torch.io.checkpoint import load_checkpoint
from llama2_tpu_torch.quant.q8 import quantize_params
from llama2_tpu_torch.runtime.batch_engine import BatchEngine, Request
from llama2_tpu_torch.runtime.generator import Generator
from llama2_tpu_torch.runtime.paged_cache import OutOfPages
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


@pytest.fixture(scope="module")
def setup(tiny_checkpoint):
    path, jconfig, jparams = tiny_checkpoint
    config, params, _ = load_checkpoint(path)
    ref = Generator(config, params, backend="torch", device="cpu")
    return config, params, ref, jconfig, jparams


def paged(config, params, **kw):
    kw.setdefault("backend", "torch")
    return PagedBatchEngine(config, params, device="cpu", **kw)


def serve(eng, prompts, gen, max_ticks=100_000):
    queues = [eng.submit(p, gen) for p in prompts]
    eng.run_until_idle(max_ticks=max_ticks)
    return [q.get(timeout=60) for q in queues]


def tokens(results):
    for r in results:
        assert not isinstance(r, Exception), r
    return [r.tokens for r in results]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_paged_equals_single_stream_and_dense_engine(setup, backend):
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=24)
    expected = [ref.generate(p, gen).tokens for p in PROMPTS]
    got = tokens(serve(paged(config, params, batch_size=3, page_size=8, n_pages=24, backend=backend),
                       PROMPTS, gen))
    assert got == expected
    dense = BatchEngine(config, params, batch_size=3, backend=backend, device="cpu")
    assert tokens(serve(dense, PROMPTS, gen)) == expected


@pytest.mark.parametrize("kv_quant", [False, True])
def test_greedy_streams_equal_the_jax_paged_engine(setup, kv_quant):
    config, params, _, jconfig, jparams = setup
    prompts = PROMPTS + [[11, 12, 13]]
    kw = dict(batch_size=2, page_size=8, n_pages=16, ticks_per_sync=3, kv_quant=kv_quant)
    jeng = JaxPagedBatchEngine(jconfig, jparams, **kw)
    jq = [jeng.submit(p, JaxGenerationConfig(temperature=0.0, steps=20)) for p in prompts]
    jeng.run_until_idle()
    want = [q.get(timeout=120).tokens for q in jq]
    got = tokens(serve(paged(config, params, **kw), prompts, GenerationConfig(temperature=0.0, steps=20)))
    assert got == want


def test_pages_released_on_retire(setup):
    config, params, _, _, _ = setup
    eng = paged(config, params, batch_size=2, page_size=8, n_pages=16)
    free0 = len(eng.pool.free)
    tokens(serve(eng, [[i + 3] for i in range(5)], GenerationConfig(temperature=0.0, steps=10)))
    assert len(eng.pool.free) == free0  # every page returned
    assert all(not p for p in eng._slot_pages)


def test_page_boundary_growth(setup):
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=20)  # past 2 pages of 8
    want = ref.generate([9], gen).tokens
    assert tokens(serve(paged(config, params, batch_size=1, page_size=8, n_pages=8), [[9]], gen)) == [want]


def test_memory_pressure_requeues_admission(setup):
    """Pages for about one request: the requests are served one after another."""
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=12)
    prompts = [[4, 8, 15], [16, 23], [42]]
    expected = [ref.generate(p, gen).tokens for p in prompts]
    eng = paged(config, params, batch_size=3, page_size=8, n_pages=6)
    assert tokens(serve(eng, prompts, gen, max_ticks=2000)) == expected


@pytest.mark.parametrize("ticks", [3, 8])
def test_paged_multi_tick_token_identical(setup, ticks):
    config, params, ref, _, _ = setup
    prompts = [[5, 17], [320, 9, 44], [7]]
    gen = GenerationConfig(temperature=0.0, steps=19)
    expected = [ref.generate(p, gen).tokens for p in prompts]
    eng = paged(config, params, batch_size=2, page_size=8, n_pages=24, ticks_per_sync=ticks)
    assert tokens(serve(eng, prompts, gen)) == expected
    assert all(not p for p in eng._slot_pages)


def test_scratch_page_never_allocated(setup):
    config, params, _, _, _ = setup
    eng = paged(config, params, batch_size=2, page_size=8, n_pages=8)
    assert 0 not in eng.pool.free
    assert 0 not in eng.pool.alloc(len(eng.pool.free))


def test_impossible_prompt_fails_fast(setup):
    config, params, _, _, _ = setup
    eng = paged(config, params, batch_size=1, page_size=8, n_pages=4)
    res = serve(eng, [list(range(2, 60))], GenerationConfig(temperature=0.0, steps=90), max_ticks=50)
    assert isinstance(res[0], OutOfPages)


def test_paged_admission_boundary(setup):
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=3)
    want = ref.generate([5, 6], gen).tokens
    assert tokens(serve(paged(config, params, batch_size=1, page_size=8, n_pages=8), [[5, 6]], gen)) == [want]


@pytest.mark.parametrize("backend", ["torch", "cuda-accurate"])
def test_paged_engine_quantized_weights(setup, backend):
    """INT8 stacked weights through the paged step (the layer index reaches
    every linear): equal to the Generator on the same backend."""
    config, params, _, _, _ = setup
    qp = quantize_params(params)
    gen = GenerationConfig(temperature=0.0, steps=10)
    want = Generator(config, qp, backend=backend, device="cpu").generate([7, 12], gen).tokens
    eng = paged(config, qp, batch_size=2, page_size=8, n_pages=16, backend=backend)
    assert tokens(serve(eng, [[7, 12]], gen)) == [want]


class Spy(PagedBatchEngine):
    """Records each preempted request's tokens at its preemption."""

    snapshots: dict

    def _decode_tick(self):
        n0 = self.metrics["preempted"]
        super()._decode_tick()
        if self.metrics["preempted"] > n0:
            for req in self._requeue:
                self.snapshots.setdefault(id(req), list(req.tokens))


def test_preemption_resumes_stream_in_place(setup):
    """A preempted request keeps its emitted tokens: re-admission replays
    prompt + generated (teacher-forced), so the final stream extends the
    pre-preemption prefix verbatim."""
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=30)
    prompts = [[4, 8], [15, 16]]
    expected = [ref.generate(p, gen).tokens for p in prompts]
    eng = Spy(config, params, batch_size=2, page_size=4, n_pages=10, backend="torch", device="cpu")
    eng.snapshots = {}
    got = tokens(serve(eng, prompts, gen, max_ticks=4000))
    assert eng.metrics["preempted"] >= 1, "the scenario must preempt"
    assert got == expected
    assert eng.snapshots
    for snap in eng.snapshots.values():
        assert any(t[: len(snap)] == snap for t in got)
    assert eng.metrics["requests"] == len(prompts) and len(eng.metrics["ttft"]) == len(prompts)


def test_preemption_threaded_loop_readmits(setup):
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=30)
    prompts = [[4, 8], [15, 16]]
    expected = [ref.generate(p, gen).tokens for p in prompts]
    eng = paged(config, params, batch_size=2, page_size=4, n_pages=10)
    eng.start()
    try:
        results = [q.get(timeout=120) for q in [eng.submit(p, gen) for p in prompts]]
    finally:
        eng.stop()
    assert tokens(results) == expected


def test_preempted_sampled_stream_identical_to_unpreempted(setup):
    """The sampling seed pins to the request at first admission and draws go
    by position, so recompute replays the same draws."""
    config, params, _, _, _ = setup
    gen = GenerationConfig(temperature=0.8, top_p=0.9, steps=24, seed=123)
    prompts = [[4, 8], [15, 16]]
    want = tokens(serve(paged(config, params, batch_size=2, page_size=4, n_pages=64), prompts, gen, 4000))
    tight = paged(config, params, batch_size=2, page_size=4, n_pages=9)
    got = tokens(serve(tight, prompts, gen, 4000))
    assert tight.metrics["preempted"] >= 1, "the scenario must preempt"
    assert got == want


def test_fail_all_reaches_requeued_requests(setup):
    config, params, _, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=4)
    for eng in (BatchEngine(config, params, batch_size=1, backend="torch", device="cpu"),
                paged(config, params, batch_size=1, page_size=8, n_pages=8)):
        req = Request(prompt=[5], gen=gen, result_q=queue.Queue())
        eng._requeue.append(req)
        boom = RuntimeError("backend lost")
        eng._fail_all(boom)
        assert req.result_q.get(timeout=5) is boom
        assert not eng._requeue


def test_paged_q8_pool_tracks_dense_q8_cache(setup):
    """An int8 pool against the dense engine's int8 cache: the same per-row
    quantization, but the paged engine quantizes its prefill rows once, after
    an fp prefill, where the dense one attends to quantized rows: the streams
    agree near-totally."""
    config, params, _, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=20)
    prompts = PROMPTS[:4]
    want = tokens(serve(BatchEngine(config, params, batch_size=2, kv_quant=True, backend="torch",
                                    device="cpu"), prompts, gen))
    got = tokens(serve(paged(config, params, batch_size=2, page_size=8, n_pages=24, kv_quant=True),
                       prompts, gen))
    agree = sum(a == b for w, g in zip(want, got) for a, b in zip(w, g))
    assert agree / sum(max(len(w), len(g)) for w, g in zip(want, got)) >= 0.9, (want, got)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_cuda_backend_equals_torch_backend_on_paged_pools(setup, kv_quant):
    """The kernel backends (plain versions here) on the paged pools give the
    plain backend's streams: fp pool and int8 pool, quantized weights."""
    config, params, _, _, _ = setup
    qp = quantize_params(params)
    gen = GenerationConfig(temperature=0.0, steps=16)
    prompts = [[5, 7, 9], [3, 4], [11]]
    runs = [tokens(serve(paged(config, qp, batch_size=2, page_size=8, n_pages=24, kv_quant=kv_quant,
                               backend=b), prompts, gen)) for b in ("torch", "cuda-accurate")]
    assert runs[0] == runs[1]


def test_prefix_cache_hits_are_token_identical(setup):
    config, params, ref, _, _ = setup
    prompt = [5, 17, 320, 9, 44, 7, 250, 4, 99, 2, 18, 31, 6, 77, 12]
    gen = GenerationConfig(temperature=0.0, steps=24)
    want = ref.generate(prompt, gen).tokens
    eng = paged(config, params, batch_size=1, page_size=8, n_pages=24, prefix_cache=True)
    assert tokens(serve(eng, [prompt], gen)) == [want]
    assert eng.metrics["prefix_hit_pages"] == 0 and eng.prefix.key2page  # cold, then registered
    assert tokens(serve(eng, [prompt], gen)) == [want]
    assert eng.metrics["prefix_hit_pages"] >= 1 and eng.prefix.hits >= 1


def test_prefix_cache_shares_pages_across_live_slots(setup):
    config, params, ref, _, _ = setup
    prompt = list(range(3, 23))
    gen = GenerationConfig(temperature=0.0, steps=32)
    want = ref.generate(prompt, gen).tokens
    eng = paged(config, params, batch_size=2, page_size=8, n_pages=24, prefix_cache=True)
    queues = [eng.submit(prompt, gen) for _ in range(2)]
    eng._admit()  # both admitted before any tick
    shared = [p for p in eng._slot_pages[0] if p in eng._slot_pages[1] and p in eng.prefix.page2key]
    assert shared and all(eng.prefix.refs[p] == 2 for p in shared)
    eng.run_until_idle()
    assert [q.get(timeout=60).tokens for q in queues] == [want, want]
    assert all(eng.prefix.refs[p] == 0 for p in eng.prefix.refs)
    assert len(eng.pool.free) + len(eng.prefix.page2key) == eng.pool.n_pages - 1


def test_prefix_cache_evicts_under_pressure(setup):
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=12)
    eng = paged(config, params, batch_size=1, page_size=4, n_pages=8, prefix_cache=True)
    for p in (list(range(2, 10)), list(range(40, 48)), list(range(80, 88))):
        assert tokens(serve(eng, [p], gen, max_ticks=2000)) == [ref.generate(p, gen).tokens]
    assert len(eng.pool.free) + len(eng.prefix.page2key) == eng.pool.n_pages - 1
    assert eng.prefix.evictable == len(eng.prefix.page2key)


def test_prefix_cache_q8_roundtrip(setup):
    """An int8 pool: cached pages dequantize into the staging plane on a hit;
    the warm stream stays near-identical to the cold one."""
    config, params, _, _, _ = setup
    prompt = [5, 17, 320, 9, 44, 7, 250, 4, 99, 2, 18, 31, 6, 77, 12]
    gen = GenerationConfig(temperature=0.0, steps=20)
    eng = paged(config, params, batch_size=1, page_size=8, n_pages=24, kv_quant=True, prefix_cache=True)
    cold = tokens(serve(eng, [prompt], gen))[0]
    warm = tokens(serve(eng, [prompt], gen))[0]
    assert eng.metrics["prefix_hit_pages"] >= 1
    assert sum(a == b for a, b in zip(cold, warm)) / max(len(cold), len(warm)) >= 0.9, (cold, warm)


def test_paged_q8_preemption_completes(setup):
    config, params, _, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=30)
    prompts = [[4, 8], [15, 16]]
    eng = paged(config, params, batch_size=2, page_size=4, n_pages=10, kv_quant=True)
    for p, got in zip(prompts, tokens(serve(eng, prompts, gen, max_ticks=4000))):
        assert got[: len(p)] == p and len(got) <= 30
    assert eng.metrics["requests"] == len(prompts)


def test_paged_pipeline_depth_does_not_change_streams(setup):
    """Including under memory pressure (preemption flushes the pipeline
    before it releases pages)."""
    config, params, _, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=16)
    prompts = [[5, 7, 9], [3, 4], [11], [2, 6, 8, 10], [4, 12]]

    def run(depth):
        eng = paged(config, params, batch_size=2, page_size=8, n_pages=10, ticks_per_sync=3,
                    pipeline_depth=depth)
        return tokens(serve(eng, prompts, gen))

    base = run(1)
    assert run(2) == base and run(3) == base


def test_prefix_hit_with_long_suffix_matches_cold_run():
    """A prefix hit whose suffix is longer than 128 tokens, pages of 16: the
    staging plane (256 rows) is shorter than the hit's offset plus the
    suffix's window (80 + 256). The JAX engine clamps that window against
    seq_len (paged_engine.py:696, fault C3), so it runs off the plane and
    its rows land in shifted pages; the port keeps the window inside the
    plane. The warm stream equals a cold run of the same prompt."""
    c = JaxModelConfig(dim=64, hidden_dim=172, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512,
                       seq_len=512)
    config = ModelConfig(**{f: getattr(c, f) for f in (
        "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size", "seq_len", "norm_eps")})
    params = random_params(c, seed=4)
    rng = np.random.default_rng(4)
    prefix = rng.integers(2, 512, 80).tolist()
    first = prefix + rng.integers(2, 512, 20).tolist()
    second = prefix + rng.integers(2, 512, 150).tolist()  # a 151-token suffix after 80 shared rows
    gen = GenerationConfig(temperature=0.0, steps=len(second) + 12)
    cold = tokens(serve(paged(config, params, batch_size=1, page_size=16, n_pages=40), [second], gen))
    eng = paged(config, params, batch_size=1, page_size=16, n_pages=40, prefix_cache=True)
    tokens(serve(eng, [first], gen))
    warm = tokens(serve(eng, [second], gen))
    assert eng.metrics["prefix_hit_pages"] == 5  # 80 rows of the shared prefix
    assert eng._staging["k"].shape[3] < 80 + 256  # the window would overrun the plane
    assert warm == cold
