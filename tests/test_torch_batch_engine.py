"""The torch port's continuous-batching engine against the JAX package and the
port's own single stream.

The contracts of ``tests/test_batch_engine.py`` that involve neither
``precompile`` nor the JAX key layout (speculative windows:
``tests/test_torch_spec_engine.py``), on the tiny checkpoint, on the CPU (``device="cpu"``; ``backend="torch"``, and
``"cuda"``, whose wrappers run their plain versions on CPU tensors):

* greedy streams equal the port ``Generator``'s, batched, reused slots, at
  ticks_per_sync 4/16 and pipeline depth 1-3, more requests than slots, a
  full-``seq_len`` stream, the admission boundary; and equal the JAX
  ``BatchEngine``'s (``xla``, fp32), token for token;
* seeded sampled streams equal the port ``Generator``'s (nucleus mode) at
  any ticks_per_sync and pipeline depth;
* degenerate requests, metrics, the background thread, failure recovery and
  ``max_retries``, the int8 cache.
"""

import numpy as np
import pytest
import torch

from llama2_tpu.config import GenerationConfig as JaxGenerationConfig
from llama2_tpu.runtime.batch_engine import BatchEngine as JaxBatchEngine
from llama2_tpu_torch.config import GenerationConfig
from llama2_tpu_torch.io.checkpoint import load_checkpoint
from llama2_tpu_torch.runtime.batch_engine import BatchEngine
from llama2_tpu_torch.runtime.generator import Generator


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


def engine(config, params, **kw):
    kw.setdefault("backend", "torch")
    return BatchEngine(config, params, device="cpu", **kw)


def serve(eng, prompts, gen, max_ticks=100_000):
    queues = [eng.submit(p, gen) for p in prompts]
    eng.run_until_idle(max_ticks=max_ticks)
    return [q.get(timeout=60) for q in queues]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_batched_equals_single_stream(setup, backend):
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=24)
    expected = [ref.generate(p, gen).tokens for p in PROMPTS]
    got = serve(engine(config, params, batch_size=3, backend=backend), PROMPTS, gen)
    assert [r.tokens for r in got] == expected


def test_greedy_streams_equal_the_jax_engine(setup):
    """The port engine and the JAX engine (``xla``, fp32) on the same
    checkpoint: token-identical streams, with slots reused."""
    config, params, _, jconfig, jparams = setup
    prompts = PROMPTS + [[11, 12, 13], [40]]
    jeng = JaxBatchEngine(jconfig, jparams, batch_size=2, ticks_per_sync=4)
    jq = [jeng.submit(p, JaxGenerationConfig(temperature=0.0, steps=20)) for p in prompts]
    jeng.run_until_idle()
    want = [q.get(timeout=120).tokens for q in jq]
    got = serve(engine(config, params, batch_size=2, ticks_per_sync=4), prompts,
                GenerationConfig(temperature=0.0, steps=20))
    assert [r.tokens for r in got] == want


@pytest.mark.parametrize("ticks", [4, 16])
def test_multi_tick_sync_token_identical(setup, ticks):
    config, params, ref, _, _ = setup
    prompts = PROMPTS[:4]
    gen = GenerationConfig(temperature=0.0, steps=21)  # not a tick multiple
    expected = [ref.generate(p, gen).tokens for p in prompts]
    got = serve(engine(config, params, batch_size=2, ticks_per_sync=ticks), prompts, gen)
    assert [r.tokens for r in got] == expected


def test_more_requests_than_slots(setup):
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=12)
    prompts = [[i + 2] for i in range(7)]
    expected = [ref.generate(p, gen).tokens for p in prompts]
    got = serve(engine(config, params, batch_size=2), prompts, gen)
    assert [r.tokens for r in got] == expected


def test_degenerate_requests(setup):
    config, params, _, _, _ = setup
    eng = engine(config, params, batch_size=2)
    q1 = eng.submit(list(range(2, 40)), GenerationConfig(temperature=0.0, steps=8))
    q2 = eng.submit([5, 1, 9], GenerationConfig(temperature=0.0, steps=16))
    eng.run_until_idle()
    assert q1.get(timeout=60).tokens == list(range(2, 10))  # echo truncated
    assert q2.get(timeout=60).tokens == [5]  # BOS inside the prompt stops


@pytest.mark.parametrize("ticks,depth", [(1, 1), (4, 2), (3, 3)])
def test_seeded_sampled_streams_equal_generator(setup, ticks, depth):
    """A seeded stream is a function of (seed, position) only: the engine's
    equal the Generator's, whatever the window and the pipeline."""
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.9, top_p=0.85, steps=18, seed=7)
    prompts = [[5, 17], [320, 9], [7]]
    expected = [ref.generate(p, gen).tokens for p in prompts]
    got = serve(engine(config, params, batch_size=2, ticks_per_sync=ticks, pipeline_depth=depth),
                prompts, gen)
    assert [r.tokens for r in got] == expected


def test_unseeded_sampled_requests_complete_and_differ(setup):
    config, params, _, _, _ = setup
    gen = GenerationConfig(temperature=0.9, top_p=0.9, steps=16)
    got = serve(engine(config, params, batch_size=2, default_seed=3), [[7]] * 3, gen)
    for res in got:
        assert 1 <= len(res.tokens) <= 16
        assert all(0 <= t < config.vocab_size for t in res.tokens)
    assert len({tuple(r.tokens) for r in got}) > 1  # a distinct seed per admission
    # the engine seed fixes them
    again = serve(engine(config, params, batch_size=2, default_seed=3), [[7]] * 3, gen)
    assert [r.tokens for r in again] == [r.tokens for r in got]


def test_metrics(setup):
    config, params, _, _, _ = setup
    eng = engine(config, params, batch_size=2)
    serve(eng, [[9]] * 3, GenerationConfig(temperature=0.0, steps=6))
    assert eng.metrics["requests"] == 3
    pct = eng.ttft_percentiles()
    assert pct["p50"] is not None and pct["p50"] > 0
    assert len(eng.metrics["queue_wait"]) == 3 and len(eng.metrics["prefill"]) == 3
    for ttft, qw, pf in zip(eng.metrics["ttft"], eng.metrics["queue_wait"], eng.metrics["prefill"]):
        assert qw >= 0 and pf >= 0
        assert abs(ttft - (qw + pf)) < 1e-6
    assert pct["queue_wait_p50"] is not None
    assert pct["prefill_p50"] is not None and pct["prefill_p50"] > 0


def test_background_thread(setup):
    config, params, _, _, _ = setup
    eng = engine(config, params, batch_size=2)
    eng.start()
    try:
        res = eng.generate([5], GenerationConfig(temperature=0.0, steps=8), timeout=120)
        assert len(res.tokens) >= 1
    finally:
        eng.stop()


def crashing(eng, crash_on_ticks):
    """Make ``eng._decode_tick`` raise on the given (1-based) calls."""
    orig = eng._decode_tick
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] in crash_on_ticks:
            raise RuntimeError(f"injected device loss (tick {calls['n']})")
        return orig()

    eng._decode_tick = flaky
    return eng


def test_engine_failure_requeues_and_resumes(setup):
    """A crashed tick rebuilds the device state and re-queues the in-flight
    request; it resumes in place and completes token-identical."""
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=8)
    want = ref.generate([5], gen).tokens
    eng = crashing(engine(config, params, batch_size=2), {3})
    eng.start()
    try:
        assert eng.generate([5], gen, timeout=120).tokens == want
        assert eng.metrics["recoveries"] == 1
        assert eng.metrics["requests"] == 1  # re-admission not counted twice
    finally:
        eng.stop()


def test_engine_failure_max_retries_zero_fails_caller(setup):
    config, params, _, _, _ = setup
    eng = crashing(engine(config, params, batch_size=2, max_retries=0), {1})
    eng.start()
    try:
        res = eng.submit([5], GenerationConfig(temperature=0.0, steps=8)).get(timeout=120)
        assert isinstance(res, RuntimeError)
        res2 = eng.generate([5], GenerationConfig(temperature=0.0, steps=8), timeout=120)
        assert len(res2.tokens) >= 1  # the engine recovered
    finally:
        eng.stop()


def test_engine_persistent_failure_gives_up_after_retries(setup):
    config, params, _, _, _ = setup
    eng = crashing(engine(config, params, batch_size=2, max_retries=2), set(range(1, 100)))
    eng.start()
    try:
        res = eng.submit([5], GenerationConfig(temperature=0.0, steps=8)).get(timeout=120)
        assert isinstance(res, RuntimeError)
        assert eng.metrics["recoveries"] == 3  # the first run and 2 retries
    finally:
        eng.stop()


def test_admission_boundary_prompt_one_below_steps(setup):
    """len(prompt) == steps - 1: exactly one sampled token is emitted."""
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=3)
    for prompt in ([5, 6], [7, 8]):
        want = ref.generate(prompt, gen).tokens
        assert serve(engine(config, params, batch_size=2), [prompt], gen)[0].tokens == want
        assert len(want) == 3


@pytest.mark.parametrize("ticks", [1, 8])
def test_full_seq_len_generation_matches_generator(setup, ticks):
    """steps == seq_len: the device freeze must not cut the last token, and
    mid-window freezes still retire the slot."""
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=0)  # the model's maximum
    want = ref.generate([9, 4], gen).tokens
    got = serve(engine(config, params, batch_size=2, ticks_per_sync=ticks), [[9, 4]], gen)
    assert got[0].tokens == want and len(want) == config.seq_len


def test_pipeline_depth_does_not_change_streams(setup):
    config, params, _, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=12)
    prompts = [[5, 7, 9], [3, 4], [11], [2, 6, 8, 10], [4]]

    def run(depth):
        return [r.tokens for r in serve(engine(config, params, batch_size=2, ticks_per_sync=3,
                                               pipeline_depth=depth), prompts, gen)]

    base = run(1)
    assert run(2) == base and run(3) == base


def test_engine_with_int8_kv_cache(setup):
    """The int8 cache through batched prefill and multi-tick decode: equal to
    the Generator over the int8 cache, and close to the fp cache's stream."""
    config, params, ref, _, _ = setup
    gen = GenerationConfig(temperature=0.0, steps=20)
    prompts = [[5, 17], [7], [320, 9, 44]]
    ref8 = Generator(config, params, backend="torch", device="cpu", kv_quant=True)
    got = serve(engine(config, params, batch_size=2, kv_quant=True, ticks_per_sync=4), prompts, gen)
    for p, res in zip(prompts, got):
        assert res.tokens == ref8.generate(p, gen).tokens
        fp = ref.generate(p, gen).tokens
        assert sum(a == b for a, b in zip(res.tokens, fp)) / len(fp) >= 0.7


def test_engine_needs_a_card_unless_asked_for_the_cpu(setup):
    config, params, _, _, _ = setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchEngine(config, params, batch_size=1)


def test_fail_all_reaches_every_request(setup):
    import queue

    from llama2_tpu_torch.runtime.batch_engine import Request

    config, params, _, _, _ = setup
    eng = engine(config, params, batch_size=1)
    gen = GenerationConfig(temperature=0.0, steps=4)
    parked = Request(prompt=[5], gen=gen, result_q=queue.Queue())
    eng._requeue.append(parked)
    waiting = eng.submit([6], gen)
    boom = RuntimeError("backend lost")
    eng._fail_all(boom)
    assert parked.result_q.get(timeout=5) is boom and waiting.get(timeout=5) is boom
    assert not eng._requeue and eng.waiting.empty()
    np.testing.assert_array_equal(eng.cache["k"].numpy(), 0)  # rebuilt
