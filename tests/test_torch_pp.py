"""The port's pipeline (``parallel/pp.py``) over a ``stage`` axis, in
spawned gloo ranks on the CPU (``parallel/distributed.py::launch`` with
``axis="stage"``), fp32, against the JAX ``parallel/pp.py`` on the 8-device
virtual mesh, under the JAX tests' own tolerances:

* ``pp_prefill`` at S = 1 and 3 (3 layers) and at stage x model 3x2
  (6 ranks): hidden within 3e-5, each stage's KV segments within 2e-5 of
  its layers of JAX's;
* ``pp_decode`` at S = 1 and 3: tokens equal to JAX's ``pp_decode`` and to
  a dense greedy loop, each stage's cache rows to the dense cache's;
  ``pp_prefill`` then ``pp_decode`` continues exactly as the dense
  prefill and decode do;
* the JAX errors: the stages do not divide the layers, M != S;
* a stage holds its layers of the weights and of the KV alone; a ``stage``
  mesh handed to the engines raises.

S = 1 runs in this process; the 3 and 3x2 launches start together from one
module fixture, the JAX references computed while the ranks run. The rank
functions import nothing of JAX (the ranks import this module)."""

import numpy as np
import pytest
import torch

from llama2_tpu_torch.config import ModelConfig
from llama2_tpu_torch.parallel import distributed

DEADLINE = 120.0  # a launch's ranks, all together
TIMEOUT = 30.0  # a collective

# conftest's tiny_config: 3 layers, 4 heads over 2 kv heads, seq_len 96
CFG = dict(dim=64, hidden_dim=172, n_layers=3, n_heads=4, n_kv_heads=2, vocab_size=512, seq_len=96)
LAUNCHES = {"3": (3, 1), "3x2": (3, 2)}
DECODE_B, DECODE_N = 2, 5  # pp_decode from an empty cache: B slots a microbatch, n steps
CONT_T, CONT_N = 8, 4  # pp_prefill of T tokens, then n decode steps


def tokens(M=3, T=12, seed=5) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (M, 1, T)).astype(np.int64)


def decode_seed(S: int) -> np.ndarray:
    return np.random.default_rng(9).integers(1, CFG["vocab_size"], (S, DECODE_B)).astype(np.int64)


# ---- what the ranks (and the S = 1 run here) compute ----


def pp_runs(mesh, params) -> dict:
    """pp_prefill; with no model axis, pp_decode from an empty cache, the
    prefill-then-decode continuation and the stage's weight bytes."""
    from llama2_tpu_torch.parallel import pp
    from llama2_tpu_torch.parallel.sp import LAYER_KEYS, rank_params

    torch.manual_seed(0)
    config = ModelConfig(**CFG)
    S, tp = mesh.shape["stage"], mesh.tp
    out = {"coord": mesh.coord}
    out["prefill"] = [a.numpy() for a in pp.pp_prefill(params, tokens(), config, mesh, model_axis=tp > 1)]
    if tp > 1:
        return out
    layers = pp._stage_layers(config, mesh)
    L_l, KVH, hs = layers.stop - layers.start, config.n_kv_heads, config.head_size
    local = rank_params(params, mesh, False, layers)
    out["layer_bytes"] = sum(local[k].numel() * local[k].element_size() for k in LAYER_KEYS)
    kc = torch.zeros((L_l, S, DECODE_B, KVH, config.seq_len, hs))
    got, kc, _ = pp.pp_decode(params, kc, torch.zeros_like(kc), decode_seed(S), np.zeros((S, DECODE_B)), DECODE_N,
                              config, mesh)
    out["decode"] = (got.numpy(), kc[:, :, :, :, :DECODE_N].numpy())
    toks = tokens(M=S, T=CONT_T)
    hidden, k_seg, v_seg = pp.pp_prefill(params, toks, config, mesh)
    logits = hidden[:, :, -1].float() @ torch.as_tensor(params["wcls"]).float()
    pad = (0, 0, 0, config.seq_len - CONT_T)
    got, _, _ = pp.pp_decode(params, torch.nn.functional.pad(k_seg, pad), torch.nn.functional.pad(v_seg, pad),
                             torch.argmax(logits, dim=-1), np.full((S, 1), CONT_T), CONT_N, config, mesh)
    out["continued"] = got.numpy()
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
def params():
    from conftest import random_params, tiny_config

    return random_params(tiny_config())


def jax_references(params) -> dict:
    """The JAX results the file holds the port to, one call a shape."""
    import jax.numpy as jnp
    from conftest import tiny_config

    from llama2_tpu.parallel.pp import make_pp_tp_mesh, make_stage_mesh, pp_decode, pp_prefill

    config = tiny_config()
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    tk = jnp.asarray(tokens(), jnp.int32)
    out = {}
    for S in (1, 3):
        out["prefill", S] = [np.asarray(a) for a in pp_prefill(pj, tk, config, make_stage_mesh(S))]
        kc = jnp.zeros((config.n_layers, S, DECODE_B, config.n_kv_heads, config.seq_len, config.head_size))
        out["decode", S] = np.asarray(pp_decode(pj, kc, kc, jnp.asarray(decode_seed(S), jnp.int32),
                                                jnp.zeros((S, DECODE_B), jnp.int32), DECODE_N, config,
                                                make_stage_mesh(S))[0])
    out["prefill", "3x2"] = [np.asarray(a) for a in pp_prefill(pj, tk, config, make_pp_tp_mesh(3, 2),
                                                               model_axis="model")]
    return out


@pytest.fixture(scope="module")
def ranks(params):
    """``({launch name: the ranks' results, "1": this process's run}, the
    JAX references)``."""
    from concurrent.futures import ThreadPoolExecutor

    from llama2_tpu_torch.parallel.mesh import make_stage_mesh

    with ThreadPoolExecutor(max_workers=len(LAUNCHES)) as pool:
        futures = {name: pool.submit(distributed.launch, pp_runs, S, tp, "cpu", params, axis="stage",
                                     deadline=DEADLINE, timeout=TIMEOUT, libraries=())
                   for name, (S, tp) in LAUNCHES.items()}
        refs = jax_references(params)
        results = {name: f.result() for name, f in futures.items()}
    results["1"] = [pp_runs(make_stage_mesh(1, "cpu"), params)]
    return results, refs


def dense_greedy(params, toks: np.ndarray, start: int, n: int, prefill: bool):
    """The one-card greedy loop of each microbatch (``models/llama.py``'s
    ``forward``): ``n`` tokens after ``toks (M, B, T)`` (prefilled with
    ``prefill``, else ``toks`` (M, B) the first decode tokens at position
    ``start``); returns ``(tokens (M, B, n), caches)``."""
    from llama2_tpu_torch.io.convert import params_from_numpy
    from llama2_tpu_torch.models.llama import forward, init_cache, logits_from_hidden

    config = ModelConfig(**CFG)
    tp = params_from_numpy(params, "cpu")
    out, caches = [], []
    for m in range(toks.shape[0]):
        B = toks.shape[1]
        cache = init_cache(config, B)
        if prefill:
            h = forward(tp, cache, torch.as_tensor(toks[m]), 0, config, "torch")
            tok = torch.argmax(logits_from_hidden(tp, h[:, -1]), dim=-1)[:, None]
        else:
            tok = torch.as_tensor(toks[m])[:, None]
        got = []
        for pos in range(start, start + n):
            h = forward(tp, cache, tok, pos, config, "torch")
            tok = torch.argmax(logits_from_hidden(tp, h[:, -1]), dim=-1)[:, None]
            got.append(tok[:, 0].numpy())
        out.append(np.stack(got, axis=1))
        caches.append(cache["k"].numpy())
    return np.stack(out), caches


def stage_rows(whole: np.ndarray, s: int, S: int) -> np.ndarray:
    n = whole.shape[0] // S
    return whole[s * n : (s + 1) * n]


@pytest.mark.parametrize("S", [1, 3])
def test_pp_prefill_matches_jax(ranks, S):
    results, refs = ranks
    hidden, k_seg, v_seg = refs["prefill", S]
    for s, res in enumerate(results[str(S)]):
        h, k, v = res["prefill"]
        np.testing.assert_allclose(h, hidden, atol=3e-5)
        np.testing.assert_allclose(k, stage_rows(k_seg, s, S), atol=2e-5)
        np.testing.assert_allclose(v, stage_rows(v_seg, s, S), atol=2e-5)


def test_pp_tp_prefill_matches_jax(ranks):
    """stage x model 3x2: a rank holds its stage's layers of its kv heads."""
    results, refs = ranks
    hidden, k_seg, v_seg = refs["prefill", "3x2"]
    for res in results["3x2"]:
        s, t = res["coord"]
        h, k, v = res["prefill"]
        np.testing.assert_allclose(h, hidden, atol=3e-5)
        for got, want in ((k, k_seg), (v, v_seg)):
            n = want.shape[3] // 2
            np.testing.assert_allclose(got, stage_rows(want, s, 3)[:, :, :, t * n : (t + 1) * n], atol=2e-5)


@pytest.mark.parametrize("S", [1, 3])
def test_pp_decode_matches_jax_and_dense_greedy(ranks, params, S):
    results, refs = ranks
    want, caches = dense_greedy(params, decode_seed(S), 0, DECODE_N, prefill=False)
    np.testing.assert_array_equal(refs["decode", S], want)
    for s, res in enumerate(results[str(S)]):
        got, kc = res["decode"]
        np.testing.assert_array_equal(got, want)
        for m in range(S):  # the stage's layers saw every appended row
            np.testing.assert_allclose(kc[:, m], stage_rows(caches[m], s, S)[:, :, :, :DECODE_N], atol=3e-5)


def test_pp_prefill_then_pp_decode_continues_exactly(ranks, params):
    want, _ = dense_greedy(params, tokens(M=3, T=CONT_T), CONT_T, CONT_N, prefill=True)
    for res in ranks[0]["3"]:
        np.testing.assert_array_equal(res["continued"], want)


def test_pp_jax_errors():
    from llama2_tpu_torch.parallel import pp
    from llama2_tpu_torch.parallel.mesh import Mesh

    config = ModelConfig(**CFG)
    with pytest.raises(ValueError, match="not divisible"):
        pp.pp_prefill({}, tokens(), config, Mesh(2, 1, 0, "cpu", axis="stage"))
    kc = torch.zeros((1, 2, 1, config.n_kv_heads, config.seq_len, config.head_size))
    with pytest.raises(ValueError, match="microbatch"):
        pp.pp_decode({}, kc, kc, np.ones((2, 1)), np.zeros((2, 1)), 3, config, Mesh(3, 1, 0, "cpu", axis="stage"))
    with pytest.raises(ValueError, match="must divide n_heads"):
        pp.pp_prefill({}, tokens(), config, Mesh(3, 4, 0, "cpu", axis="stage"), model_axis=True)


def test_stage_holds_only_its_layers(ranks, params):
    """A stage's layer-stack weights are 1/S of the stack's bytes, its KV
    segments its L/S layers."""
    from llama2_tpu_torch.parallel.sp import LAYER_KEYS

    whole = sum(params[k].nbytes for k in LAYER_KEYS)
    for res in ranks[0]["3"]:
        assert res["layer_bytes"] * 3 == whole
        assert res["prefill"][1].shape[0] == CFG["n_layers"] // 3
    assert ranks[0]["1"][0]["layer_bytes"] == whole


def test_stage_mesh_is_never_a_data_mesh(params):
    from llama2_tpu_torch.parallel.mesh import Mesh, make_pp_tp_mesh, make_stage_mesh
    from llama2_tpu_torch.runtime.batch_engine import BatchEngine

    mesh = Mesh(3, 1, 2, "cpu", axis="stage")
    assert mesh.shape == {"stage": 3, "model": 1}
    with pytest.raises(ValueError, match="leads with 'stage'"):
        BatchEngine(ModelConfig(**CFG), params, batch_size=2, backend="torch", device="cpu", mesh=mesh)
    assert make_stage_mesh(1, "cpu").axis == "stage"
    with pytest.raises(ValueError, match="needs 6 ranks"):
        make_pp_tp_mesh(3, 2, "cpu")
