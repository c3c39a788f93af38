"""The torch port's model over the int8 KV cache against the JAX package.

* ``init_cache(kv_quant=True)``: int8 rows, float32 per-row scales, the
  position pad.
* ``forward`` with an int8 cache: prefill segments of at most 16 tokens
  (the int8 window kernel K7), longer ones (the dequantized cache), decode
  steps of a batch whose rows sit at their own positions. On the config of
  ``tests/test_layer_block.py`` (head size 128) both packages run a decode
  step through the whole-layer kernel (K13) for INT8 weights on the fast
  kernel backend; at ``tiny_config`` (fp weights, GQA, head size 16) the
  port's ``cuda`` runs K7/K8 while the JAX ``pallas`` takes its dequantized
  fallback. CPU tensors run the port's plain versions, the JAX side its
  Pallas kernels in interpret mode.

Tolerance: logits to 2e-2, ``cuda`` <-> ``pallas`` (the bound of
``tests/test_torch_model_q8.py`` for the fast pair) and ``torch`` <-> ``xla``
alike (``pytest -s`` prints the largest seen). The int8 cache takes away the
fp cache's 1e-4 for the plain pair: the compiled JAX model computes a row's
scale as ``amax * (1/127)``, one float32 ulp off the division that JAX's
``quantize_kv_rows`` and the port compute in some rows, and an element on a
rounding boundary then takes the next int8 code (a step of ``amax/127``),
which the layers after carry (1 to 3 codes a prefill here, 2e-3 in logits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_params, tiny_config
from llama2_tpu.config import ModelConfig
from llama2_tpu.models import llama as jm
from llama2_tpu_torch.config import ModelConfig as TorchModelConfig
from llama2_tpu_torch.io.convert import params_from_numpy
from llama2_tpu_torch.models import llama as tm
from llama2_tpu_torch.ops.cuda import attention_q8 as aq
from llama2_tpu_torch.ops.cuda import layer_block as lb
from test_torch_layer_block import _cfg, both_trees


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread here: beside the JAX runtime's threads, and the
    other test workers', more threads only slow these small shapes down."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

TOL = 2e-2


def port_config(c: ModelConfig) -> TorchModelConfig:
    return TorchModelConfig(**{f: getattr(c, f) for f in (
        "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size", "seq_len", "norm_eps")})


def test_init_cache_int8_layout():
    config = port_config(tiny_config())
    c = tm.init_cache(config, 2, torch.float32, "cpu", kv_quant=True)
    assert sorted(c) == ["k", "k_scale", "v", "v_scale"]
    assert c["k"].dtype == c["v"].dtype == torch.int8
    assert c["k_scale"].dtype == c["v_scale"].dtype == torch.float32
    assert c["k"].shape == (3, 2, 2, 96, 16) and c["k_scale"].shape == (3, 2, 2, 96)
    assert not any(t.any() for t in c.values())
    dense = tm.init_cache(config, 2, torch.float32, "cpu")
    assert c["k"].nbytes * 4 == dense["k"].nbytes
    padded = tm.init_cache(config, 1, torch.float32, "cpu", kv_quant=True, pad=4)
    assert padded["k"].shape[3] == padded["k_scale"].shape[3] == 100
    j = jm.init_cache(tiny_config(), 2, kv_quant=True)
    assert {k: tuple(v.shape) for k, v in j.items()} == {k: tuple(v.shape) for k, v in c.items()}


def _fp_trees(config, seed=0):
    params = random_params(config, seed)
    return {k: jnp.asarray(v) for k, v in params.items()}, params_from_numpy(params, "cpu", torch.float32)


def _run_both(jp, tp, config, jbackend, tbackend):
    """Segments and steps through both forwards on int8 caches; returns the
    largest logit difference and the two caches."""
    pcfg = port_config(config)
    worst = 0.0

    def step(jcache, tcache, tok, pos):
        nonlocal worst
        hj, jcache = jm.forward(jp, jcache, jnp.asarray(tok), jnp.asarray(pos), config, backend=jbackend)
        lj = np.asarray(jm.logits_from_hidden(jp, hj, backend=jbackend))
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        ht = tm.forward(tp, tcache, torch.from_numpy(tok).long(), tpos, pcfg, tbackend)
        lt = tm.logits_from_hidden(tp, ht, tbackend).numpy()
        np.testing.assert_allclose(lt, lj, rtol=TOL, atol=TOL)
        worst = max(worst, float(np.abs(lt - lj).max()))
        return jcache, lj

    jcache = jm.init_cache(config, 1, kv_quant=True)
    tcache = tm.init_cache(pcfg, 1, torch.float32, "cpu", kv_quant=True)
    long_prompt = np.arange(1, 21, dtype=np.int32)[None] % config.vocab_size  # 20 > 16 tokens
    for tok, pos in ((np.array([[1, 5, 17, 100, 9]], np.int32), 0), (np.array([[44]], np.int32), 5),
                     (np.array([[3, 8, 2]], np.int32), 6), (long_prompt, 9)):
        jcache, _ = step(jcache, tcache, tok, pos)

    jcache = jm.init_cache(config, 2, kv_quant=True)
    tcache = tm.init_cache(pcfg, 2, torch.float32, "cpu", kv_quant=True)
    toks, pos = np.array([[5], [9]], np.int32), np.array([0, 3], np.int32)
    for _ in range(8):
        jcache, lj = step(jcache, tcache, toks, pos)
        toks = lj[:, -1].argmax(-1).astype(np.int32)[:, None]  # both follow the JAX stream
        pos = pos + 1
    return worst, jcache, tcache


@pytest.mark.parametrize("jbackend,tbackend", [("pallas", "cuda"), ("xla", "torch")])
def test_forward_whole_layer_config_matches_jax(jbackend, tbackend):
    """INT8 weights at head size 128: on the fast backends both packages run
    the whole-layer kernel a decode layer."""
    config = _cfg()
    jp, tp = both_trees(config, seed=11)
    assert lb.layer_block_supported(*(tp[k] for k in ("wo", "w1", "w3", "w2", "wqkv")), port_config(config))
    worst, jcache, tcache = _run_both(jp, tp, config, jbackend, tbackend)
    np.testing.assert_array_equal(tcache["k"].numpy() != 0, np.asarray(jcache["k"]) != 0)
    print(f"largest logit difference {tbackend} vs {jbackend}: {worst:.3e}")  # pytest -s


@pytest.mark.parametrize("jbackend,tbackend", [("pallas", "cuda"), ("xla", "torch")])
def test_forward_tiny_config_matches_jax(jbackend, tbackend):
    """fp weights, GQA, head size 16: the port's K7/K8 against the JAX
    package's dequantized route (its kernels need head size 128)."""
    config = tiny_config()
    jp, tp = _fp_trees(config)
    worst, _, _ = _run_both(jp, tp, config, jbackend, tbackend)
    print(f"largest logit difference {tbackend} vs {jbackend} (tiny): {worst:.3e}")  # pytest -s


def decode_logits(tp, pcfg, backend, feed=None, steps: int = 8):
    """Logits of ``steps`` decode steps of a batch of two rows at their own
    positions: greedy, or teacher-forced by ``feed`` (a list of token pairs)."""
    cache = tm.init_cache(pcfg, 2, torch.float32, "cpu", kv_quant=True)
    toks, pos = torch.tensor([[5], [9]]), torch.tensor([0, 2], dtype=torch.int32)
    out = []
    for i in range(steps):
        hidden = tm.forward(tp, cache, toks, pos, pcfg, backend)
        lg = tm.logits_from_hidden(tp, hidden[:, -1, :], backend)
        out.append(lg)
        toks = (lg.argmax(-1) if feed is None else torch.tensor(feed[i]))[:, None]
        pos = pos + 1
    return torch.stack(out)


# the route a decode step takes -> (predicates switched off, backend, wrapper
# calls per step at L layers: K6 from models/llama.py, K13, K9, K12, K11, K8)
ROUTES = {
    "whole-layer": ((), "cuda", lambda L: (1, L, 0, 0, 0, 0)),
    "two-launch": (("layer_block_supported",), "cuda", lambda L: (1, 0, L, L - 1, 1, 0)),
    "accurate": ((), "cuda-accurate", lambda L: (0, 0, 0, 0, 0, L)),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_decode_routes_calls_and_logits(monkeypatch, route):
    """The int8 cache's decode routes, with the calls per step counted, each
    teacher-forced by the whole-layer route's greedy stream. As the JAX test
    holds its whole-layer kernel against the two-launch pair, the logits agree
    to 2e-2 of their largest magnitude: the routes differ in how this step's
    row joins attention (float32 or bf16 value), so a near-tie may resolve
    either way (ROADMAP fault C1), and tokens are compared only where the
    top-2 margin exceeds twice the routes' distance."""
    config = _cfg()
    pcfg = port_config(config)
    _, tp = both_trees(config, seed=11)
    want = decode_logits(tp, pcfg, "cuda")
    feed = want.argmax(-1).tolist()
    off, backend, per_step = ROUTES[route]
    for name in off:
        monkeypatch.setattr(tm, name, lambda *a: False)
    names = ("quant_matmul_stacked", "layer_block_stacked", "flash_decode_attention_q8_fused",
             "layer_tail_qkv_stacked", "attn_mlp_block_stacked", "flash_decode_attention_q8_stacked")
    calls = dict.fromkeys(names, 0)

    def counted(name):
        orig = getattr(tm, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(tm, name, wrapper)

    for name in names:
        counted(name)
    got = decode_logits(tp, pcfg, backend, feed)
    assert tuple(calls.values()) == tuple(8 * n for n in per_step(config.n_layers))
    assert lb.layer_block_stacked.launches == aq.flash_decode_attention_q8_fused.launches == 0  # CPU never launches
    dist = float((got - want).abs().max())
    assert dist <= 2e-2 * float(want.abs().max())
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * dist
    assert (got.argmax(-1) == want.argmax(-1))[clear].all() and int(clear.sum()) >= 8
    print(f"{route}: logit distance from the whole-layer route {dist:.3e}, "
          f"{int(clear.sum())} of 16 tokens with a clear margin")  # pytest -s
