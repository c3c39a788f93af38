"""The torch port's 2-launch Q8 decode layer against the JAX package.

At widths where the JAX package's FFN megakernels engage (model width a
multiple of 128, head size 128; the configs of
``tests/test_mlp_block.py::test_attn_mlp_model_path_token_parity`` and
``::test_layer_tail_qkv_model_token_parity``) both packages keep ``w1``/``w3``
separate for the fast kernel backend and run a decode layer as the glue-fused
attention plus ONE megakernel: ``layer_tail_qkv_stacked`` for layers
``0..L-2`` with the next layer's pre-RoPE QKV carried to it,
``attn_mlp_block_stacked`` for the last layer, and one rmsnorm-fused
dequant-matmul a step for layer 0's QKV. The JAX side runs its Pallas kernels
in interpret mode, the port its plain versions (CPU tensors).

Tolerance: ``cuda`` <-> ``pallas`` logits and hidden states to 2e-2, the
bound of ``tests/test_torch_model_q8.py`` for the fast pair (a flipped bf16
rounding of one operand, carried by the layers after it); the largest seen
here is printed by ``pytest -s``. Greedy tokens are compared where the JAX
top-2 logit margin exceeds that bound; the ``Generator`` and CLI comparisons
are token- and byte-exact on these seeds.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOKENIZER_BIN
from llama2_tpu import cli as jax_cli
from llama2_tpu.config import GenerationConfig as JaxGenerationConfig
from llama2_tpu.config import ModelConfig
from llama2_tpu.io.checkpoint import save_checkpoint
from llama2_tpu.models import llama as jm
from llama2_tpu.quant import q8 as jq
from llama2_tpu.runtime.generator import Generator as JaxGenerator
from llama2_tpu_torch.config import GenerationConfig
from llama2_tpu_torch.config import ModelConfig as TorchModelConfig
from llama2_tpu_torch.io.convert import params_from_numpy
from llama2_tpu_torch.models import llama as tm
from llama2_tpu_torch.ops.cuda import mlp_block as mb
from llama2_tpu_torch.quant import q8 as tq
from llama2_tpu_torch.runtime.generator import Generator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-2


def _cfg(n_layers: int, **kw) -> ModelConfig:
    base = dict(dim=256, hidden_dim=384, n_layers=n_layers, n_heads=2, n_kv_heads=2,
                vocab_size=128, seq_len=128, norm_eps=1e-5)
    base.update(kw)
    return ModelConfig(**base)


# (config, seed) of the two JAX tests named above
CASES = {"2L": (_cfg(2), 0), "3L": (_cfg(3), 4)}


def port_config(c: ModelConfig) -> TorchModelConfig:
    return TorchModelConfig(**{f: getattr(c, f) for f in (
        "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size",
        "seq_len", "norm_eps")})


def fp_params(config: ModelConfig, seed: int) -> dict:
    """The JAX tests' recipe: N(0, 0.05) matrices, 1 + N(0, 0.05) norm weights."""
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


def both_trees(config: ModelConfig, seed: int, group_size: int = 64):
    """The same quantized params, unfused, for each package."""
    params = fp_params(config, seed)
    tree = dict(params)
    for k, t in tq.quantize_params(params, group_size).items():
        if isinstance(t, tq.QuantTensor):
            tree[k] = (t.q.numpy(), t.scale.numpy(), t.group_size)
    jp = {
        k: jq.QuantTensor(q=jnp.asarray(v[0]), scale=jnp.asarray(v[1]), group_size=v[2])
        if isinstance(v, tuple) else jnp.asarray(v)
        for k, v in tree.items()
    }
    return jp, params_from_numpy(tree, "cpu", torch.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_fused_trees_hold_the_same_keys(name):
    """What crosses between the packages is the unfused tree; fused for the
    fast kernel backend both keep w1/w3 separate, with equal bytes."""
    config, seed = CASES[name]
    jp, tp = both_trees(config, seed)
    jf, tf = jm.fuse_layer_params(jp, "pallas"), tm.fuse_layer_params(tp, "cuda")
    assert jm.use_mlp_block(jf, "pallas") and tm.use_mlp_block(tf, "cuda")
    assert set(jf) == set(tf) and "w13" not in tf
    assert tm.layer_keys(tf) == jm.layer_keys(jf) == ("rms_att", "wqkv", "wo", "rms_ffn", "w1", "w3", "w2")
    for k, v in tf.items():
        if isinstance(v, tq.QuantTensor):
            np.testing.assert_array_equal(v.q.numpy(), np.asarray(jf[k].q))
            np.testing.assert_array_equal(v.scale.numpy(), np.asarray(jf[k].scale))
        else:
            np.testing.assert_array_equal(v.numpy(), np.asarray(jf[k]))
    # any other backend gets the w13 layout, on which "cuda" runs the composed route
    assert "w13" in tm.fuse_layer_params(tp, "torch") and "w13" in tm.fuse_layer_params(tp, "cuda-accurate")


@pytest.mark.parametrize("name", list(CASES))
def test_forward_two_launch_matches_jax(name):
    """A prefill segment (separate w1/w3 launches), two decode steps, then
    eight greedy steps of a batch of two rows at their own positions."""
    config, seed = CASES[name]
    pcfg = port_config(config)
    jp, tp = both_trees(config, seed)
    jp, tp = jm.fuse_layer_params(jp, "pallas"), tm.fuse_layer_params(tp, "cuda")
    worst = 0.0

    def step(jcache, tcache, tok, pos):
        nonlocal worst
        hj, jcache = jm.forward(jp, jcache, jnp.asarray(tok), jnp.asarray(pos), config, backend="pallas")
        lj = np.asarray(jm.logits_from_hidden(jp, hj[:, -1, :], backend="pallas"))
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        ht = tm.forward(tp, tcache, torch.from_numpy(tok).long(), tpos, pcfg, "cuda")
        lt = tm.logits_from_hidden(tp, ht[:, -1, :], "cuda").numpy()
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(lt, lj, rtol=TOL, atol=TOL)
        worst = max(worst, float(np.abs(lt - lj).max()))
        return jcache, lj, lt

    jcache, tcache = jm.init_cache(config, 1), tm.init_cache(pcfg, 1, torch.float32, "cpu")
    for tok, pos in ((np.array([[1, 5, 17, 100, 9]], np.int32), 0), (np.array([[44]], np.int32), 5),
                     (np.array([[3]], np.int32), 6)):
        jcache, _, _ = step(jcache, tcache, tok, pos)

    jcache, tcache = jm.init_cache(config, 2), tm.init_cache(pcfg, 2, torch.float32, "cpu")
    toks, pos = np.array([[5], [9]], np.int32), np.array([0, 3], np.int32)
    compared = 0
    for _ in range(8):
        jcache, lj, lt = step(jcache, tcache, toks, pos)
        top2 = np.sort(lj, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * TOL * (1 + np.abs(top2[:, 1]))
        assert (lt.argmax(-1) == lj.argmax(-1))[clear].all()
        compared += int(clear.sum())
        toks = lj.argmax(-1).astype(np.int32)[:, None]  # both follow the JAX stream
        pos = pos + 1
    assert compared >= 4
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), rtol=TOL, atol=TOL)
    print(f"largest logit difference cuda vs pallas ({name}): {worst:.3e}")  # shown by pytest -s


def greedy(tp, pcfg, steps: int = 8):
    cache = tm.init_cache(pcfg, 2, torch.float32, "cpu")
    toks, pos = torch.tensor([[5], [9]]), torch.tensor([0, 0], dtype=torch.int32)
    out = []
    for _ in range(steps):
        hidden = tm.forward(tp, cache, toks, pos, pcfg, "cuda")
        toks = tm.logits_from_hidden(tp, hidden[:, -1, :], "cuda").argmax(-1)[:, None]
        pos = pos + 1
        out.append(toks[:, 0].tolist())
    return out


# which megakernel predicates are switched off -> the wrappers' calls per
# decode step at L layers: (K6 from models/llama.py, K4, K10, K11, K12)
ROUTES = {
    "two-launch": ((), lambda L: (1, L, 0, 1, L - 1)),
    "wo+ffn": (("layer_tail_qkv_supported",), lambda L: (L, L, 0, L, 0)),
    "ffn-only": (("layer_tail_qkv_supported", "attn_mlp_block_supported"), lambda L: (2 * L, L, L, 0, 0)),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_decode_routes_calls_and_token_parity(monkeypatch, route):
    """The port's order of preference, as the JAX package has it: the 2-launch
    layer; else wo + FFN in one launch per layer; else residual-fused wo and
    the FFN megakernel. Each gives the composed route's greedy tokens over 8
    steps (the JAX contract of ``test_layer_tail_qkv_model_token_parity``, fp
    cache), with the calls per step counted."""
    config, seed = CASES["3L"]
    pcfg = port_config(config)
    _, tp = both_trees(config, seed)
    mlp, w13 = tm.fuse_layer_params(tp, "cuda"), tm.fuse_layer_params(tp, "torch")
    want = greedy(w13, pcfg)

    off, per_step = ROUTES[route]
    for name in off:
        monkeypatch.setattr(tm, name, lambda *a: False)
    calls = dict.fromkeys(("quant_matmul_stacked", "flash_decode_attention_fused", "mlp_block_stacked",
                           "attn_mlp_block_stacked", "layer_tail_qkv_stacked"), 0)

    def counted(name):
        orig = getattr(tm, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(tm, name, wrapper)

    for name in calls:
        counted(name)
    import llama2_tpu_torch.ops.linear as tlin

    monkeypatch.setattr(tlin, "quant_matmul_stacked",
                        lambda *a, **kw: pytest.fail("a projection left the fused routes"))
    assert greedy(mlp, pcfg) == want
    assert tuple(calls.values()) == tuple(8 * n for n in per_step(config.n_layers))
    assert mb.mlp_block_stacked.launches == mb.layer_tail_qkv_stacked.launches == 0  # the CPU never launches


def test_generator_token_identical_to_jax():
    """fp32, temperature 0: the port's Generator on the 2-launch route against
    the JAX Generator on ``pallas``, whole-prompt and chunked prefill."""
    config, seed = _cfg(3), 0  # seven of eight seeds tried agree on every prompt; 4 has a near-tie
    params = fp_params(config, seed)
    jg = JaxGenerator(config, jq.quantize_params(params, 64), backend="pallas")
    tg = Generator(port_config(config), tq.quantize_params(params, 64), backend="cuda", device="cpu")
    assert "w13" not in tg.params and "w13" not in jg.params
    for prompt, steps, chunk in (([], 24, None), ([5, 17, 100, 9], 28, None), ([5, 17, 100, 9, 44, 2, 77], 24, 3)):
        want = jg.generate(prompt, JaxGenerationConfig(temperature=0.0, steps=steps), prefill_chunk=chunk)
        got = tg.generate(prompt, GenerationConfig(temperature=0.0, steps=steps), prefill_chunk=chunk)
        assert got.tokens == want.tokens
        assert len(got.tokens) > len(prompt)


def test_cli_bytes_match_jax_cli_on_the_fast_kernel_route(capsysbinary, tmp_path):
    """``--quant int8 --kernels cuda`` against the JAX CLI's ``--kernels
    pallas`` on a checkpoint wide enough for the megakernels of both."""
    config, seed = _cfg(3, vocab_size=512), 4
    path = str(tmp_path / "wide.bin")
    params = fp_params(config, seed)
    params["wcls"] = params["tok_emb"].T
    save_checkpoint(path, config, params, shared_weights=True)
    args = (path, "-t", "0", "-n", "24", "--platform", "cpu", "-z", TOKENIZER_BIN, "--quant", "int8",
            "-i", "Once upon")
    assert jax_cli.main([*args, "--kernels", "pallas"]) == 0
    want = capsysbinary.readouterr().out
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    tr = subprocess.run(
        [sys.executable, "-m", "llama2_tpu_torch", *args, "--kernels", "cuda", "-v"],
        capture_output=True, timeout=240, env=env, cwd=REPO,
    )
    assert tr.returncode == 0, tr.stderr.decode()
    assert tr.stdout == want and len(want) > 0
    assert b"kernels: cuda" in tr.stderr
