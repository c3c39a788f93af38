"""The port's paged engine over a ``(data, model)`` mesh
(``PagedBatchEngine(mesh=)``, ``parallel/dp_paged.py``) in spawned gloo
ranks on the CPU (``parallel/distributed.py::launch``; the ``cuda``
backend's kernels run their plain versions on CPU tensors), fp32, greedy
unless a case says otherwise:

* at 1x2, 2x1 and 2x2 over the fp pool (Q8 weights, ``backend="cuda"``):
  every rank's streams token-identical to the one-rank port engine's; the
  paged mesh path taken (``_dp``), each rank's pool 1/(dp*tp) of the
  one-card pool at the same page count, its page ids below its group's
  share;
* at 2x2 on ``backend="torch"`` with fp weights: the streams of the JAX
  ``PagedBatchEngine(mesh=make_mesh(2, 2))`` (one JAX run);
* at 2x1: a seeded sampled run at ``ticks_per_sync=3``, speculative
  windows, the int8 pool, and the prefix cache under page pressure (hits
  in both data groups, preemption inside a group) equal to their one-card
  runs; at 1x2 the int8 pool too;
* the refusal: ``batch_size % dp`` warns that the pool REPLICATES over
  data, holds every page on every rank and equals the one-card streams;
* the server ``--paged --mesh 1x2 --collective-matmul --platform cpu`` in
  a subprocess: three concurrent greedy answers equal to the one-card paged
  engine's, and SIGINT ends it (exit 0).

Every launch of the file and the server start together in one module
fixture. The rank functions import nothing of JAX: the ranks import this
module."""

import json
import os
import re
import signal
import subprocess
import sys
import threading
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

# head size 128: the paged tick takes the glue-fused attention (K17/K18)
CFG = dict(dim=256, hidden_dim=512, n_layers=2, n_heads=2, n_kv_heads=2, vocab_size=128, seq_len=128)
# the JAX dp_paged tests' model: tp = 2 leaves 4 heads over 2 kv heads a rank
JAX_CFG = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=8, n_kv_heads=4, vocab_size=256, seq_len=48)
GROUP = 64
PROMPTS = [[5, 17], [99, 9, 44], [7], [33, 2, 8]]
GREEDY = dict(temperature=0.0, steps=14)
SAMPLED = dict(temperature=0.8, top_p=0.9, steps=12, seed=11)
PAGED = dict(page_size=8, n_pages=40)
# the prefix cache under pressure: each data group's pair of prompts (slots
# 0, 1 | 2, 3) shares a 16-token prefix, two full pages, so hits land in
# both groups; 7 pages a group (6 past its scratch page) cannot hold both
# of its 40-token streams (2 shared pages + 3 each), so one is preempted
PREFIX_PROMPTS = [[3] * 17, [3] * 17 + [9], [5] * 17, [5] * 17 + [4]]
PREFIX = dict(page_size=8, n_pages=14, prefix_cache=True)
SERVER_PROMPTS = ("a b", "c", "d e f")
SERVER_STEPS = 12


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


def spec(config=CFG, quant=True, backend="cuda", gen=GREEDY, prompts=PROMPTS, paged=PAGED, batch_size=4,
         **kw) -> dict:
    engine = dict(batch_size=batch_size, backend=backend, dtype=torch.float32, **paged, **kw)
    return {"config": config, "quant": quant, "engine": engine, "prompts": prompts, "gen": gen}


def pool_bytes(pool) -> int:
    return sum(t.numel() * t.element_size() for t in (pool.k, pool.v, pool.ks, pool.vs) if t is not None)


# ---- what the ranks run ----


def engine_case(mesh, case: dict) -> dict:
    """One paged engine's streams on this rank and what it held."""
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = PagedBatchEngine(ModelConfig(**case["config"]), weights(case["config"], case["quant"]), mesh=mesh,
                               **case["engine"])
    taken = []
    alloc = eng._alloc

    def noted(n, slot=0):
        pages = alloc(n, slot)
        taken.extend(pages)
        return pages

    eng._alloc = noted
    streams = serve(eng, case["prompts"], case["gen"], mesh.rank == 0)
    return {"streams": streams, "warnings": [str(w.message) for w in caught], "dp": eng._dp,
            "backend": eng.backend, "pool_shape": tuple(eng.pool.k.shape), "pool_bytes": pool_bytes(eng.pool),
            "max_page": max(taken, default=0), "metrics": {k: v for k, v in eng.metrics.items()
                                                            if k in ("prefix_hit_pages", "preempted",
                                                                     "prefix_hit_pages_by_shard", "spec_windows")}}


def run_cases(mesh, cases: dict) -> dict:
    torch.manual_seed(0)
    return {name: engine_case(mesh, case) for name, case in cases.items()}


CASES = {
    (1, 2): {"fp": spec(), "int8": spec(kv_quant=True)},
    (2, 1): {"fp": spec(), "sampled": spec(gen=SAMPLED, ticks_per_sync=3),
             "spec": spec(spec_window=4, ticks_per_sync=2), "int8": spec(kv_quant=True),
             "prefix": spec(prompts=PREFIX_PROMPTS, paged=PREFIX, gen=dict(temperature=0.0, steps=40)),
             "refused": spec(batch_size=3)},
    (2, 2): {"fp": spec(), "jax": spec(config=JAX_CFG, quant=False, backend="torch",
                                       paged=dict(page_size=8, n_pages=48)),
             "refused": spec(batch_size=3)},
}


# ---- the launches, the server, and the one-card references in this process ----


_ONE_CARD: dict = {}


def one_card(case: dict) -> tuple:
    """The case's streams and pool bytes from a one-card paged engine (once a case)."""
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

    key = repr((sorted(case["config"].items()), case["quant"], sorted(case["engine"].items()), case["gen"],
                case["prompts"]))
    if key not in _ONE_CARD:
        eng = PagedBatchEngine(ModelConfig(**case["config"]), weights(case["config"], case["quant"]), device="cpu",
                               **case["engine"])
        _ONE_CARD[key] = serve(eng, case["prompts"], case["gen"]), pool_bytes(eng.pool), eng.pool.n_pages
    return _ONE_CARD[key]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The one-card references run on one thread, as the ranks do."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def start_server(path: str) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "llama2_tpu_torch.runtime.server", path, "-z", TOKENIZER_BIN, "--platform", "cpu",
           "--port", "0", "--paged", "--page-size", "8", "--kernels", "torch", "--mesh", "1x2",
           "--collective-matmul"]
    return subprocess.Popen(cmd, cwd=REPO, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def launches(tiny_checkpoint):
    """``{(dp, tp): future of the ranks' results}`` and ``"server"``: the
    server's process, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    out = {"server": start_server(tiny_checkpoint[0])}
    try:
        with ThreadPoolExecutor(max_workers=3) as pool:
            for (dp, tp), cases in CASES.items():
                out[dp, tp] = pool.submit(distributed.launch, run_cases, dp, tp, "cpu", cases, deadline=DEADLINE,
                                          timeout=TIMEOUT)
            yield out
    finally:
        if out["server"].poll() is None:
            out["server"].kill()
        out["server"].wait(timeout=30)
        out["server"].stderr.close()


def check(results: list, mesh: tuple, name: str) -> list:
    """Every rank's streams of case ``name`` equal the one-card engine's;
    returns the ranks' results of it."""
    want = one_card(CASES[mesh][name])[0]
    for rank, res in enumerate(results):
        assert res[name]["streams"] == want, (mesh, name, rank)
    return [res[name] for res in results]


# ---- the tests ----


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)])
def test_paged_mesh_streams_equal_one_card_and_pools_shard(launches, mesh):
    dp, tp = mesh
    results = launches[mesh].result()
    assert len(results) == dp * tp
    _, one_bytes, n_pages = one_card(CASES[mesh]["fp"])
    for res in check(results, mesh, "fp"):
        assert res["backend"] == "cuda" and not res["warnings"]
        assert res["dp"] == (dp if dp > 1 else 0)
        assert res["pool_shape"][1:3] == (n_pages // dp, CFG["n_kv_heads"] // tp)
        assert res["pool_bytes"] * dp * tp == one_bytes  # 1/(dp*tp) of the one-card pool
        assert 0 < res["max_page"] < n_pages // dp  # local ids, below the group's share


def test_paged_mesh_torch_equals_the_jax_engine(launches):
    from llama2_tpu.config import GenerationConfig as JaxGenerationConfig
    from llama2_tpu.config import ModelConfig as JaxModelConfig
    from llama2_tpu.parallel.mesh import make_mesh
    from llama2_tpu.runtime.paged_engine import PagedBatchEngine as JaxPagedBatchEngine

    case = CASES[2, 2]["jax"]
    eng = JaxPagedBatchEngine(JaxModelConfig(**JAX_CFG), tree(JAX_CFG), batch_size=4, backend="xla",
                              mesh=make_mesh(2, 2), page_size=case["engine"]["page_size"],
                              n_pages=case["engine"]["n_pages"])
    assert eng._dp == 2
    queues = [eng.submit(p, JaxGenerationConfig(**GREEDY)) for p in PROMPTS]
    eng.run_until_idle()
    want = [q.get(timeout=60).tokens for q in queues]
    for res in launches[2, 2].result():
        assert res["jax"]["backend"] == "torch" and res["jax"]["dp"] == 2
        assert res["jax"]["streams"] == want


@pytest.mark.parametrize("mesh,name", [((2, 1), "sampled"), ((2, 1), "spec"), ((2, 1), "int8"), ((2, 1), "prefix"),
                                       ((1, 2), "int8")])
def test_dp_paged_runs_equal_one_card(launches, mesh, name):
    ranks = check(launches[mesh].result(), mesh, name)
    m = ranks[0]["metrics"]
    if name == "spec":
        assert m["spec_windows"] > 0
    if name == "prefix":
        # hits in both data groups, and a preemption inside one
        assert all(n >= 1 for n in m["prefix_hit_pages_by_shard"]) and m["preempted"] >= 1
        assert sum(m["prefix_hit_pages_by_shard"]) == m["prefix_hit_pages"]


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_refused_mesh_warns_and_replicates_over_data(launches, mesh):
    dp, tp = mesh
    _, one_bytes, n_pages = one_card(CASES[mesh]["refused"])
    for res in check(launches[mesh].result(), mesh, "refused"):
        assert any("paged pool REPLICATES over data" in w and "batch_size=3 not divisible by dp=2" in w
                   for w in res["warnings"])
        assert res["dp"] == 0 and res["pool_shape"][1] == n_pages  # every page on every rank
        assert res["pool_bytes"] * tp == one_bytes


def _post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_server_paged_mesh_ring_serves_and_stops(launches, tiny_checkpoint):
    from llama2_tpu_torch.io import load_any
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine
    from llama2_tpu_torch.tokenizer.fast import load_tokenizer

    proc = launches["server"]
    try:
        lines = []
        while not any("serving on" in line for line in lines):
            line = proc.stderr.readline()
            assert line, "".join(lines)
            lines.append(line)
        assert "[mesh] 2 ranks on the CPU: gloo\n" in lines
        url = re.search(r"http://[\d.]+:\d+", lines[-1]).group(0)
        got = [None] * len(SERVER_PROMPTS)

        def ask(i):
            got[i] = _post(url + "/generate", {"prompt": SERVER_PROMPTS[i], "temperature": 0.0,
                                               "steps": SERVER_STEPS})["tokens"]

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(SERVER_PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    config, params, _ = load_any(tiny_checkpoint[0])
    tok = load_tokenizer(TOKENIZER_BIN, config.vocab_size)
    eng = PagedBatchEngine(config, params, backend="torch", device="cpu", page_size=8)
    assert got == serve(eng, [tok.encode(p) for p in SERVER_PROMPTS], dict(temperature=0.0, steps=SERVER_STEPS))
