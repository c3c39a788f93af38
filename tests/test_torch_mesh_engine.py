"""The port's tensor- and data-parallel serving in spawned gloo ranks on the
CPU (``parallel/distributed.py::launch``; the ``cuda`` backend runs its
kernels' plain versions on CPU tensors):

* the sharded ``forward`` + ``logits_from_hidden`` at tp = 2 (a 5-token
  prefill chunk, then one decode step) at head size 128, where the decode
  layer takes the glue-fused attention: on ``cuda`` within 2e-3 of the
  largest logit of the port's one-card forward, with the calls counted per
  layer (K6 twice, K4 once, K10 once with ``residual=False``; K5 once a
  step, K1 once a layer of the chunk; K11-K13 never); on ``torch`` within
  1e-4 of it of the JAX package's mesh forward (``backend="xla"``,
  ``shard_map`` over ``make_mesh(1, 2)``: its ``pallas`` twin runs about
  10 s in interpret mode here, too long for this file's share of the
  suite);
* ``BatchEngine(mesh=)`` at (1, 2), (2, 1) and (2, 2), fp and int8 cache,
  fp32 activations, Q8 weights: greedy streams on every rank token-identical
  to the one-card engine's, and at (1, 2) on ``torch`` to the JAX one-card
  engine's; a seeded sampled run at ``ticks_per_sync=3`` and
  ``spec_window=4`` equal to their one-card runs; the warned fallbacks of a
  model the kernels (or nothing) can shard;
* a rank that raises fails ``launch`` within its deadline;
* the server with ``--mesh 1x2 --platform cpu`` in a subprocess: three
  concurrent greedy answers equal to the in-process mesh engine's,
  ``/health``, and SIGINT ends it (exit 0) and its follower.

The rank functions import nothing of JAX: the ranks import this module."""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
import warnings

import numpy as np
import pytest
import torch

from llama2_tpu_torch.config import GenerationConfig, ModelConfig
from llama2_tpu_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER_BIN = os.path.join(REPO, "tests", "fixtures", "tokenizer.bin")
DEADLINE = 120.0  # a launch's ranks, all together
TIMEOUT = 30.0  # a collective

# head size 128: the decode layer takes the glue-fused attention (K4/K9)
CFG = dict(dim=256, hidden_dim=512, n_layers=2, n_heads=2, n_kv_heads=2, vocab_size=128, seq_len=128)
GROUP = 64
PROMPTS = [[5, 17], [99, 9, 44], [7], [33, 2, 8]]
GREEDY = dict(temperature=0.0, steps=14)
SAMPLED = dict(temperature=0.8, top_p=0.9, steps=12, seed=11)
SERVER_PROMPTS = ("a b", "c", "d e f")
SERVER_STEPS = 12
FWD_TOL = 2e-3  # cuda mesh forward against one card, a fraction of the largest |logit|
JAX_TOL = 1e-4  # torch mesh forward against the JAX mesh forward, the same


def tree(config: dict = CFG, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.standard_normal(s, np.float32) * 0.07

    c = ModelConfig(**config)
    L, D, HD, V, KV = c.n_layers, c.dim, c.hidden_dim, c.vocab_size, c.kv_dim
    return {
        "tok_emb": r(V, D), "rms_att": 1 + r(L, D), "wq": r(L, D, D), "wk": r(L, D, KV), "wv": r(L, D, KV),
        "wo": r(L, D, D), "rms_ffn": 1 + r(L, D), "w1": r(L, D, HD), "w2": r(L, HD, D), "w3": r(L, D, HD),
        "rms_final": 1 + r(D), "wcls": r(D, V),
    }


def weights(config: dict, quant: bool) -> dict:
    from llama2_tpu_torch.quant.q8 import quantize_params

    t = {k: torch.from_numpy(v) for k, v in tree(config).items()}
    return quantize_params(t, GROUP) if quant else t


def serve(eng, prompts, gen: dict, lead: bool = True) -> list:
    """Every request's tokens: rank 0 submits, a follower reads its mirrors."""
    queues = [eng.submit(p, GenerationConfig(**gen)) for p in prompts] if lead else []
    eng.run_until_idle()
    out = []
    for q in queues if lead else eng.followed:
        r = q.get(timeout=5)
        if isinstance(r, Exception):
            raise r
        out.append(r.tokens)
    return out


# ---- what the ranks run ----


class Calls:
    """Counts the kernel wrappers the model calls (their plain versions on
    the CPU), K10's by its residual flag."""

    NAMES = {"K1": ("llama", "flash_prefill_attention"), "K4": ("llama", "flash_decode_attention_fused"),
             "K6-qkv": ("llama", "quant_matmul_stacked"), "K6": ("linear", "quant_matmul_stacked"),
             "K5": ("linear", "quant_matmul"), "K10": ("llama", "mlp_block_stacked"),
             "K11": ("llama", "attn_mlp_block_stacked"), "K12": ("llama", "layer_tail_qkv_stacked"),
             "K13": ("llama", "layer_block_stacked")}

    def __init__(self):
        from llama2_tpu_torch.models import llama
        from llama2_tpu_torch.ops import linear

        self.counts = dict.fromkeys(self.NAMES, 0)
        self.counts["K10-residual"] = 0
        for tag, (mod, name) in self.NAMES.items():
            module = llama if mod == "llama" else linear
            setattr(module, name, self._wrap(tag, getattr(module, name)))

    def _wrap(self, tag, fn):
        def counted(*a, **kw):
            self.counts[tag] += 1
            if tag == "K10" and kw.get("residual", True):
                self.counts["K10-residual"] += 1
            return fn(*a, **kw)

        return counted

    def take(self) -> dict:
        out, self.counts = self.counts, dict.fromkeys(self.counts, 0)
        return out


def forward_case(mesh, spec: dict) -> dict:
    """The sharded forward on ``cuda`` (counted) and ``torch``: a 5-token
    prefill chunk at 0, then one decode step at 5; the logits of both."""
    from llama2_tpu_torch.models.llama import forward, init_cache, logits_from_hidden
    from llama2_tpu_torch.parallel.sharding import shard_params
    from llama2_tpu_torch.parallel.tp import local_config
    from llama2_tpu_torch.runtime.generator import prepare_params

    config = ModelConfig(**CFG)
    local = shard_params(weights(CFG, True), mesh)
    calls = Calls()
    out = {}
    for backend in ("cuda", "torch"):
        params = prepare_params(local, torch.float32, backend, mesh.device)
        cache = init_cache(local_config(config, mesh.tp), 1, torch.float32, mesh.device, spec["kv_quant"])
        logits, counts = [], []
        for tok, pos in ((spec["prompt"], 0), ([spec["next"]], len(spec["prompt"]))):
            hidden = forward(params, cache, torch.tensor([tok]), pos, config, backend, mesh)
            logits.append(logits_from_hidden(params, hidden[:, -1], backend, mesh).numpy())
            counts.append(calls.take())
        out[backend] = {"logits": logits, "counts": counts}
    return out


def engine_case(mesh, spec: dict) -> dict:
    """One engine's streams on this rank, its backend and its warnings."""
    from llama2_tpu_torch.io import load_any
    from llama2_tpu_torch.runtime.batch_engine import BatchEngine

    if "path" in spec:
        config, params, _ = load_any(spec["path"])
    else:
        config, params = ModelConfig(**spec["config"]), weights(spec["config"], spec["quant"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = BatchEngine(config, params, mesh=mesh, **spec["engine"])
    streams = serve(eng, spec["prompts"], spec["gen"], mesh.rank == 0)
    return {"backend": eng.backend, "streams": streams, "warnings": [str(w.message) for w in caught],
            "spec_windows": eng.metrics["spec_windows"]}


def run_cases(mesh, cases: dict) -> dict:
    """Each case in order on every rank."""
    torch.manual_seed(0)
    return {name: (forward_case if spec.get("forward") else engine_case)(mesh, spec)
            for name, spec in cases.items()}


def failing_rank(mesh):
    """Rank 1 raises; rank 0 waits in an all-reduce that never completes."""
    if mesh.rank == 1:
        raise ValueError("planted rank failure")
    torch.distributed.all_reduce(torch.ones(1), group=mesh.model_group)


# ---- the cases, and their one-card twins in this process ----


def engine_spec(quant=True, kv_quant=False, backend="cuda", gen=GREEDY, config=CFG, **kw) -> dict:
    engine = dict(batch_size=4, backend=backend, kv_quant=kv_quant, dtype=torch.float32, **kw)
    return {"config": config, "quant": quant, "engine": engine, "prompts": PROMPTS, "gen": gen}


def cases_for(dp: int, tp: int) -> dict:
    return {f"q8-{kv}": engine_spec(kv_quant=kv == "int8") for kv in ("fp", "int8")}


# the rest of the tp = 2 cases, a launch of their own beside the others
MORE_12 = {
    "forward": {"forward": True, "kv_quant": False, "prompt": [1, 5, 17, 99, 9], "next": 44},
    "torch": engine_spec(backend="torch"),
    "sampled": engine_spec(gen=SAMPLED, ticks_per_sync=3),
    "spec": engine_spec(spec_window=4, ticks_per_sync=2),
    # fp weights: the kernels do not shard them, the plain path does
    "fp-weights": engine_spec(quant=False),
    # one kv head: nothing shards it
    "mqa": engine_spec(config=dict(CFG, n_kv_heads=1)),
}


_ONE_CARD: dict = {}


def one_card(spec: dict, backend: str) -> list:
    """The case's streams from a one-card engine on ``backend`` (once a case)."""
    from llama2_tpu_torch.runtime.batch_engine import BatchEngine

    key = repr((sorted(spec["config"].items()), spec["quant"], sorted(spec["engine"].items()), spec["gen"], backend))
    if key not in _ONE_CARD:
        kw = dict(spec["engine"], backend=backend)
        eng = BatchEngine(ModelConfig(**spec["config"]), weights(spec["config"], spec["quant"]), device="cpu", **kw)
        _ONE_CARD[key] = serve(eng, spec["prompts"], spec["gen"])
    return _ONE_CARD[key]


def check_streams(results: list, cases: dict) -> None:
    """Every rank's streams equal the one-card engine's on the backend the
    mesh engine ran."""
    for name, spec in cases.items():
        if spec.get("forward") or "path" in spec:
            continue
        want = one_card(spec, results[0][name]["backend"])
        for rank, res in enumerate(results):
            assert res[name]["streams"] == want, (name, rank)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The one-card references run on one thread, as the ranks do: beside
    the JAX runtime's threads more only slow these small shapes down."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


FAIL_DEADLINE = 60.0  # the failing launch's deadline


def timed_failure():
    """``launch`` of :func:`failing_rank`: ``(the error it raised, seconds)``."""
    t0 = time.perf_counter()
    try:
        distributed.launch(failing_rank, 1, 2, "cpu", deadline=FAIL_DEADLINE, timeout=TIMEOUT)
    except Exception as e:  # noqa: BLE001 -- the test reads it
        return e, time.perf_counter() - t0
    return None, time.perf_counter() - t0


def start_server(path: str) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "llama2_tpu_torch.runtime.server", path, "-z", TOKENIZER_BIN,
           "--platform", "cpu", "--port", "0", "--mesh", "1x2"]
    return subprocess.Popen(cmd, cwd=REPO, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def launches(tiny_checkpoint):
    """Every launch of this file and the mesh server, started together (they
    share the host's cores, one thread a rank): ``{(dp, tp): (cases, future
    of the ranks' results)}``, ``"more"``: the rest of the tp = 2 cases and
    the server's requests, ``"failing"``: the future of
    :func:`timed_failure`, ``"server"``: the server's process."""
    from concurrent.futures import ThreadPoolExecutor

    from llama2_tpu_torch.tokenizer.fast import load_tokenizer

    path, jconfig, _ = tiny_checkpoint
    tok = load_tokenizer(TOKENIZER_BIN, jconfig.vocab_size)
    more = dict(MORE_12, server={
        "path": path, "engine": dict(batch_size=8, backend="cuda", dtype=torch.float32),
        "prompts": [tok.encode(p) for p in SERVER_PROMPTS], "gen": dict(temperature=0.0, steps=SERVER_STEPS),
    })
    out = {"server": start_server(path)}
    try:
        with ThreadPoolExecutor(max_workers=5) as pool:
            for key, dp, tp, cases in (((1, 2), 1, 2, cases_for(1, 2)), ("more", 1, 2, more),
                                       ((2, 1), 2, 1, cases_for(2, 1)), ((2, 2), 2, 2, cases_for(2, 2))):
                out[key] = cases, pool.submit(distributed.launch, run_cases, dp, tp, "cpu", cases,
                                              deadline=DEADLINE, timeout=TIMEOUT)
            out["failing"] = pool.submit(timed_failure)
            yield out
    finally:
        if out["server"].poll() is None:
            out["server"].kill()
        out["server"].wait(timeout=30)
        out["server"].stderr.close()


@pytest.fixture(scope="module")
def mesh12(launches):
    """The tp = 2 cases and the ranks' results of them, both launches'."""
    (cases, a), (more, b) = launches[1, 2], launches["more"]
    return {**cases, **more}, [{**x, **y} for x, y in zip(a.result(), b.result())]


# ---- the tests ----


def test_sharded_forward_matches_one_card_and_jax(mesh12):
    import jax.numpy as jnp

    from llama2_tpu.config import ModelConfig as JaxModelConfig
    from llama2_tpu.models import llama as jm
    from llama2_tpu.parallel.mesh import make_mesh
    from llama2_tpu.parallel.sharding import shard_cache, shard_params
    from llama2_tpu.quant.q8 import quantize_params as jax_quantize
    from llama2_tpu_torch.models.llama import forward, init_cache, logits_from_hidden
    from llama2_tpu_torch.runtime.generator import prepare_params

    cases, results = mesh12
    spec = cases["forward"]
    steps = ((spec["prompt"], 0), ([spec["next"]], len(spec["prompt"])))
    # the one-card port forward on cuda (plain versions)
    config = ModelConfig(**CFG)
    params = prepare_params(weights(CFG, True), torch.float32, "cuda", torch.device("cpu"))
    cache = init_cache(config, 1)
    one = []
    for tok, pos in steps:
        h = forward(params, cache, torch.tensor([tok]), pos, config, "cuda")
        one.append(logits_from_hidden(params, h[:, -1], "cuda").numpy())
    # the JAX mesh forward (shard_map over (1, 2), xla)
    jconfig = JaxModelConfig(**CFG)
    mesh = make_mesh(1, 2)
    jp = shard_params(jax_quantize(tree(), group_size=GROUP), mesh)
    jc = shard_cache(jm.init_cache(jconfig, 1), mesh)
    jax_logits = []
    for tok, pos in steps:
        h, jc = jm.forward(jp, jc, jnp.asarray([tok], jnp.int32), pos, jconfig, backend="xla", mesh=mesh)
        jax_logits.append(np.asarray(jm.logits_from_hidden(jp, h[:, -1], backend="xla")))
    for res in results:  # every rank holds the full vocab rows
        fwd = res["forward"]
        for got, want in zip(fwd["cuda"]["logits"], one):
            assert np.abs(got - want).max() <= FWD_TOL * np.abs(want).max()
        for got, want in zip(fwd["torch"]["logits"], jax_logits):
            assert np.abs(got - want).max() <= JAX_TOL * np.abs(want).max()
        prefill, decode = fwd["cuda"]["counts"]
        L = CFG["n_layers"]
        assert decode == {"K1": 0, "K4": L, "K6-qkv": L, "K6": L, "K5": 1, "K10": L, "K10-residual": 0,
                          "K11": 0, "K12": 0, "K13": 0}
        assert prefill == {"K1": L, "K4": 0, "K6-qkv": 0, "K6": 5 * L, "K5": 1, "K10": 0, "K10-residual": 0,
                           "K11": 0, "K12": 0, "K13": 0}
        assert not any(fwd["torch"]["counts"][1].values())  # torch launches nothing


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 1), (2, 2)])
def test_mesh_engine_streams_equal_one_card(dp, tp, launches):
    cases, future = launches[dp, tp]
    results = future.result()
    cases = {k: cases[k] for k in ("q8-fp", "q8-int8")}
    assert len(results) == dp * tp
    for res in results:
        assert res["q8-fp"]["backend"] == res["q8-int8"]["backend"] == "cuda"
        assert not res["q8-fp"]["warnings"]
    check_streams(results, cases)


def test_mesh_torch_engine_equals_the_jax_engine(mesh12):
    from llama2_tpu.config import GenerationConfig as JaxGenerationConfig
    from llama2_tpu.config import ModelConfig as JaxModelConfig
    from llama2_tpu.quant.q8 import quantize_params as jax_quantize
    from llama2_tpu.runtime.batch_engine import BatchEngine as JaxBatchEngine

    _, results = mesh12
    eng = JaxBatchEngine(JaxModelConfig(**CFG), jax_quantize(tree(), group_size=GROUP), batch_size=4, backend="xla")
    queues = [eng.submit(p, JaxGenerationConfig(**GREEDY)) for p in PROMPTS]
    eng.run_until_idle()
    want = [q.get(timeout=60).tokens for q in queues]
    for res in results:
        assert res["torch"]["backend"] == "torch" and res["torch"]["streams"] == want


def test_mesh_sampled_multi_tick_and_spec_equal_one_card(mesh12):
    cases, results = mesh12
    for name in ("sampled", "spec"):
        want = one_card(cases[name], "cuda")
        for res in results:
            assert res[name]["streams"] == want, name
    assert all(res["spec"]["spec_windows"] > 0 for res in results)
    # the spec streams are the plain greedy ones
    assert results[0]["spec"]["streams"] == results[0]["q8-fp"]["streams"]


def test_unshardable_models_warn_and_run_on_torch(mesh12):
    cases, results = mesh12
    for res in results:
        fp, mqa = res["fp-weights"], res["mqa"]
        assert fp["backend"] == mqa["backend"] == "torch"
        assert any("wq is not a layer-stacked QuantTensor" in w for w in fp["warnings"])
        assert not any("replicated" in w for w in fp["warnings"])  # the plain path shards fp weights
        assert any("does not divide n_kv_heads=1" in w and "falling back to backend='torch'" in w
                   for w in mqa["warnings"])
        assert any("every rank holds the whole model" in w for w in mqa["warnings"])
    check_streams(results, {k: cases[k] for k in ("fp-weights", "mqa")})


def test_a_failing_rank_fails_the_launch_within_its_deadline(launches):
    err, seconds = launches["failing"].result()
    assert isinstance(err, distributed.RankError) and "planted rank failure" in str(err)
    assert seconds < FAIL_DEADLINE


def _post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _children(pid: int) -> list[int]:
    out = []
    for task in os.listdir(f"/proc/{pid}/task"):
        with open(f"/proc/{pid}/task/{task}/children") as f:
            out += [int(c) for c in f.read().split()]
    return out


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_server_mesh_serves_and_stops(mesh12, launches):
    _, results = mesh12
    proc = launches["server"]
    children = []
    try:
        lines = []
        while not any("serving on" in line for line in lines):
            line = proc.stderr.readline()
            assert line, "".join(lines)
            lines.append(line)
        assert "[mesh] 2 ranks on the CPU: gloo\n" in lines
        url = re.search(r"http://[\d.]+:\d+", lines[-1]).group(0)
        children = _children(proc.pid)
        got = [None] * len(SERVER_PROMPTS)

        def ask(i):
            got[i] = _post(url + "/generate", {"prompt": SERVER_PROMPTS[i], "temperature": 0.0,
                                               "steps": SERVER_STEPS})["tokens"]

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(SERVER_PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert got == results[0]["server"]["streams"] == results[1]["server"]["streams"]
        with urllib.request.urlopen(url + "/health", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
    finally:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    end = time.monotonic() + 10
    while not all(_gone(c) for c in children) and time.monotonic() < end:
        time.sleep(0.1)
    assert children and all(_gone(c) for c in children)
