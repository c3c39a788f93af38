"""The port's ring collective matmul (``parallel/collective_matmul.py``) in
spawned gloo ranks on the CPU (``parallel/distributed.py::launch``), fp32:

* ``row_parallel_linear`` at tp 2 against the JAX package's on the
  8-device virtual mesh (one call), within 1e-5 of the largest output, and
  against the dense product at tp 2 and 4;
* ``ring_rs_matmul``'s chunk placement at tp 4 (rank ``i`` ends with
  out-chunk ``i``, summed over the ranks: the JAX test's);
* ``ring_linear_local`` on a layer-stacked Q8 shard, and where ``out``
  does not split over tp (the plain all-reduce), against the dense product;
* ``row_parallel_linear``'s ``ValueError`` where ``in`` or ``out`` does not
  divide tp, and the hop count: ``2 * (tp - 1)`` a linear, ``2 * (tp - 1) *
  2L`` a sharded forward;
* ``collective="ring"`` on both engines at 1x2 (Q8 weights, fp32
  activations, ``backend="cuda"``, whose kernels run their plain versions
  here): greedy streams on every rank token-identical to their psum twins
  and to the one-card engines'; the paged engine over the int8 pool on
  ``backend="torch"``, where both forms' products are the dequantized
  weight's (on ``cuda`` the psum form's ``wo`` is fast-mode K6, whose
  rounding the int8 pool's row quantization may turn into another token).

Each launch's ranks are spawned once, together, by one module fixture. The
rank functions import nothing of JAX: the ranks import this module."""

import numpy as np
import pytest
import torch

from llama2_tpu_torch.config import GenerationConfig, ModelConfig
from llama2_tpu_torch.parallel import distributed

DEADLINE = 90.0  # a launch's ranks, all together
TIMEOUT = 30.0  # a collective
TOL = 1e-5  # a fraction of the largest |output|

# head size 128: the decode layer takes the glue-fused attention
CFG = dict(dim=256, hidden_dim=512, n_layers=2, n_heads=2, n_kv_heads=2, vocab_size=128, seq_len=128)
GROUP = 64
PROMPTS = [[5, 17], [99, 9, 44], [7], [33, 2, 8]]
GREEDY = dict(temperature=0.0, steps=14)
PAGED = dict(page_size=8, n_pages=40)


def rng_x_w(seed: int, *shape_x_w):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shape_x_w]


def tree(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.standard_normal(s, np.float32) * 0.07

    c = ModelConfig(**CFG)
    L, D, HD, V, KV = c.n_layers, c.dim, c.hidden_dim, c.vocab_size, c.kv_dim
    return {
        "tok_emb": r(V, D), "rms_att": 1 + r(L, D), "wq": r(L, D, D), "wk": r(L, D, KV), "wv": r(L, D, KV),
        "wo": r(L, D, D), "rms_ffn": 1 + r(L, D), "w1": r(L, D, HD), "w2": r(L, HD, D), "w3": r(L, D, HD),
        "rms_final": 1 + r(D), "wcls": r(D, V),
    }


def q8_weights() -> dict:
    from llama2_tpu_torch.quant.q8 import quantize_params

    return quantize_params({k: torch.from_numpy(v) for k, v in tree().items()}, GROUP)


def serve(eng, lead: bool, gen: dict = GREEDY) -> list:
    """Every request's tokens: rank 0 submits, a follower reads its mirrors."""
    queues = [eng.submit(p, GenerationConfig(**gen)) for p in PROMPTS] if lead else []
    eng.run_until_idle()
    out = []
    for q in queues if lead else eng.followed:
        r = q.get(timeout=5)
        if isinstance(r, Exception):
            raise r
        out.append(r.tokens)
    return out


# ---- what the ranks run ----


def ring_math(mesh) -> dict:
    """The ring functions on this rank: their outputs and hop counts."""
    from llama2_tpu_torch.parallel import collective_matmul as cm
    from llama2_tpu_torch.quant.q8 import QuantTensor, quantize

    tp, t = mesh.tp, mesh.coord[1]
    out = {}
    x, w = (torch.from_numpy(a) for a in rng_x_w(tp, (3, 5, 64), (64, 32)))
    h0 = cm.hops
    out["row_parallel"] = cm.row_parallel_linear(x, w, mesh).numpy()
    out["hops_a_linear"] = cm.hops - h0
    # the chunk placement: rank i's chunk of x @ w
    x2, w2 = (torch.from_numpy(a) for a in rng_x_w(1, (2, 16), (16, 8)))
    c = 16 // tp
    out["chunk"] = cm.ring_rs_matmul(x2[:, t * c : (t + 1) * c], w2[t * c : (t + 1) * c], mesh.model_group).numpy()
    # a layer-stacked Q8 shard, indexed by its layer: the rank's in-rows
    wq = quantize(torch.from_numpy(rng_x_w(5, (2, 128, 64))[0]), 32)
    rows = slice(t * 128 // tp, (t + 1) * 128 // tp)
    y = torch.from_numpy(rng_x_w(6, (4, 128))[0])
    shard = QuantTensor(wq.q[:, rows].contiguous(), wq.scale[:, t * 4 // tp : (t + 1) * 4 // tp].contiguous(), 32)
    out["q8"] = cm.ring_linear_local(y[:, rows], shard, mesh.model_group, layer=1).numpy()
    # out = 30 does not split over 4: the plain all-reduce (no hop)
    w30 = torch.from_numpy(rng_x_w(7, (64, 30))[0])
    h0 = cm.hops
    out["unchunked"] = cm.ring_linear_local(x[..., t * 64 // tp : (t + 1) * 64 // tp],
                                            w30[t * 64 // tp : (t + 1) * 64 // tp], mesh.model_group).numpy()
    out["unchunked_hops"] = cm.hops - h0
    try:
        cm.row_parallel_linear(x, torch.zeros(64, 30), mesh)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def ring_forward_hops(mesh) -> int:
    """The hops of one sharded decode step with ``collective="ring"``."""
    from llama2_tpu_torch.models.llama import forward, init_cache
    from llama2_tpu_torch.parallel import collective_matmul as cm
    from llama2_tpu_torch.parallel.sharding import shard_params
    from llama2_tpu_torch.parallel.tp import local_config
    from llama2_tpu_torch.runtime.generator import prepare_params

    config = ModelConfig(**CFG)
    params = prepare_params(shard_params(q8_weights(), mesh), torch.float32, "cuda", mesh.device, ring=True)
    cache = init_cache(local_config(config, mesh.tp), 1)
    h0 = cm.hops
    forward(params, cache, torch.tensor([[5]]), 0, config, "cuda", mesh, "ring")
    return cm.hops - h0


def ring_engines(mesh) -> dict:
    """Both engines with ``collective="ring"`` and their psum twins."""
    from llama2_tpu_torch.runtime.batch_engine import BatchEngine
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

    config, params = ModelConfig(**CFG), q8_weights()
    kw = dict(batch_size=4, backend="cuda", dtype=torch.float32, device="cpu", mesh=mesh)
    out = {"forward_hops": ring_forward_hops(mesh)}
    for name, make in (
        ("dense", lambda c: BatchEngine(config, params, collective=c, **kw)),
        ("paged", lambda c: PagedBatchEngine(config, params, collective=c, **PAGED, **kw)),
        ("paged-int8", lambda c: PagedBatchEngine(config, params, collective=c, kv_quant=True, **PAGED,
                                                  **dict(kw, backend="torch"))),
    ):
        for c in ("ring", None):
            eng = make(c)
            out[name, c] = {"streams": serve(eng, mesh.rank == 0), "collective": eng.collective,
                            "w13": "w13" in eng.params}
    return out


def rank_main(mesh) -> dict:
    torch.manual_seed(0)
    out = {"math": ring_math(mesh)}
    if mesh.tp == 2:
        out.update(ring_engines(mesh))
    return out


# ---- the launches, and the references in this process ----


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The one-card references run on one thread, as the ranks do."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks():
    """``{tp: the ranks' results}`` of the 1x2 and 1x4 launches, started
    together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = {tp: pool.submit(distributed.launch, rank_main, 1, tp, "cpu", deadline=DEADLINE, timeout=TIMEOUT)
                   for tp in (2, 4)}
        return {tp: f.result() for tp, f in futures.items()}


def close(got, want, tol=TOL) -> None:
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_row_parallel_linear_matches_jax_and_dense(ranks):
    import jax
    import jax.numpy as jnp

    from llama2_tpu.parallel.collective_matmul import row_parallel_linear
    from llama2_tpu.parallel.mesh import make_mesh

    x, w = rng_x_w(2, (3, 5, 64), (64, 32))
    want = np.asarray(row_parallel_linear(jnp.asarray(x), jnp.asarray(w), make_mesh(1, 2, devices=jax.devices()[:2])))
    for res in ranks[2]:
        close(res["math"]["row_parallel"], want)
    for tp in (2, 4):
        x, w = rng_x_w(tp, (3, 5, 64), (64, 32))
        for res in ranks[tp]:  # every rank holds the whole product
            close(res["math"]["row_parallel"], x @ w)


def test_ring_rs_matmul_chunk_placement(ranks):
    x, w = rng_x_w(1, (2, 16), (16, 8))
    want = x @ w
    for i, res in enumerate(ranks[4]):
        close(res["math"]["chunk"], want[:, i * 2 : (i + 1) * 2])


def test_ring_linear_local_q8_shard_and_unchunked_out(ranks):
    from llama2_tpu_torch.quant.q8 import dequantize, quantize

    wq = quantize(torch.from_numpy(rng_x_w(5, (2, 128, 64))[0]), 32)
    y = rng_x_w(6, (4, 128))[0]
    want = y @ dequantize(wq[1]).numpy()
    x, w30 = rng_x_w(4, (3, 5, 64))[0], rng_x_w(7, (64, 30))[0]
    for tp in (2, 4):
        for res in ranks[tp]:
            close(res["math"]["q8"], want)
            close(res["math"]["unchunked"], x @ w30 if tp == 4 else rng_x_w(2, (3, 5, 64))[0] @ w30)


def test_indivisible_raises_and_hops_counted(ranks):
    for tp in (2, 4):
        for res in ranks[tp]:
            m = res["math"]
            assert m["indivisible"] == f"(64, 30) not divisible by tp={tp}" if tp == 4 else m["indivisible"] is None
            assert m["hops_a_linear"] == 2 * (tp - 1)
            assert m["unchunked_hops"] == (2 * (tp - 1) if 30 % tp == 0 else 0)
    L = CFG["n_layers"]
    assert all(res["forward_hops"] == 2 * 1 * 2 * L for res in ranks[2])


_ONE_CARD: dict = {}


def one_card(name: str) -> list:
    from llama2_tpu_torch.runtime.batch_engine import BatchEngine
    from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

    if name not in _ONE_CARD:
        config, params = ModelConfig(**CFG), q8_weights()
        kw = dict(batch_size=4, backend="torch" if name == "paged-int8" else "cuda", dtype=torch.float32,
                  device="cpu")
        eng = (BatchEngine(config, params, **kw) if name == "dense"
               else PagedBatchEngine(config, params, kv_quant=name == "paged-int8", **PAGED, **kw))
        _ONE_CARD[name] = serve(eng, True)
    return _ONE_CARD[name]


@pytest.mark.parametrize("name", ["dense", "paged", "paged-int8"])
def test_ring_engines_equal_their_psum_twins_and_one_card(ranks, name):
    for res in ranks[2]:
        ring, psum = res[name, "ring"], res[name, None]
        assert ring["collective"] == "ring" and psum["collective"] is None
        if name != "paged-int8":  # on cuda the ring's composed FFN reads w13; torch reads w13 either way
            assert ring["w13"] and not psum["w13"]
        assert ring["streams"] == psum["streams"] == one_card(name)
