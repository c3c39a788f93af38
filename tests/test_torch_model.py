"""The torch port's model, weight bridge, checkpoint and tokenizer copies
against the JAX package.

``params_from_numpy`` turns the same seeded numpy params into tensors; the
port's ``forward``/``logits_from_hidden`` (a prefill segment, then decode
steps) are held against the JAX ``forward`` with ``backend="xla"`` and with
``backend="pallas"`` (its kernels in interpret mode, on a lane-padded cache)
over the fp rows of ``tests/test_parity_matrix.py``. Tolerance for fp32
hidden states and logits: 1e-4 relative and absolute (three layers of
summation-order differences over the 2e-5 of one attention call).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOKENIZER_BIN, random_params
from llama2_tpu.config import ModelConfig
from llama2_tpu.io.checkpoint import load_checkpoint as jax_load
from llama2_tpu.io.checkpoint import save_checkpoint as jax_save
from llama2_tpu.models import llama as jm
from llama2_tpu.tokenizer.tokenizer import Tokenizer as JaxTokenizer
from llama2_tpu_torch.config import ModelConfig as TorchModelConfig
from llama2_tpu_torch.io import load_any
from llama2_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from llama2_tpu_torch.io.convert import params_from_numpy
from llama2_tpu_torch.io.convert import random_params as torch_random_params
from llama2_tpu_torch.models import llama as tm
from llama2_tpu_torch.tokenizer.tokenizer import Tokenizer

TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(**kw) -> ModelConfig:
    base = dict(dim=64, hidden_dim=172, n_layers=3, n_heads=4, n_kv_heads=2,
                vocab_size=512, seq_len=96)
    base.update(kw)
    return ModelConfig(**base)


def port_config(c: ModelConfig) -> TorchModelConfig:
    return TorchModelConfig(**{f: getattr(c, f) for f in (
        "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size",
        "seq_len", "norm_eps")})


def unshare(params: dict, seed: int) -> dict:
    """The classifier with its own weights (test_parity_matrix.py::_unshare)."""
    rng = np.random.default_rng(seed + 1000)
    out = dict(params)
    out["wcls"] = 0.08 * rng.standard_normal(params["wcls"].shape).astype(np.float32)
    return out


# the fp rows of tests/test_parity_matrix.py::MATRIX, with the port's backend
# beside the JAX one (a port backend uses its plain versions on the CPU)
MATRIX = [
    ("gqa_shared_xla", _cfg(), True, "xla", "torch"),
    ("unshared_cls_xla", _cfg(), False, "xla", "torch"),
    ("mqa_xla", _cfg(n_kv_heads=1), True, "xla", "cuda"),
    ("mha_odd_dim_xla", _cfg(dim=60, n_heads=6, n_kv_heads=6, hidden_dim=144), True, "xla", "cuda"),
    ("lane_pad_pallas", _cfg(), True, "pallas", "cuda"),
    ("mqa_unshared_pallas", _cfg(n_kv_heads=1), False, "pallas", "cuda"),
]


def make_params(name, config, shared):
    params = random_params(config, seed=zlib.crc32(name.encode()))
    return params if shared else unshare(params, 7)


@pytest.mark.parametrize("name,config,shared,jax_backend,backend", MATRIX, ids=[m[0] for m in MATRIX])
def test_forward_matches_jax(name, config, shared, jax_backend, backend):
    params = make_params(name, config, shared)
    hs = config.head_size
    tokens = np.array([[1, 5, 17, 320, 9]], np.int32)
    steps = [(tokens, 0), (np.array([[44]], np.int32), 5), (np.array([[3]], np.int32), 6)]

    jcache = jm.init_cache(config, lane_pad=jax_backend == "pallas" and hs % 128 != 0)
    pcfg = port_config(config)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    tcache = tm.init_cache(pcfg, 1, torch.float32, "cpu")
    for tok, pos in steps:
        hj, jcache = jm.forward(params, jcache, jnp.asarray(tok), pos, config, backend=jax_backend)
        lj = jm.logits_from_hidden(params, hj, backend=jax_backend)
        ht = tm.forward(tparams, tcache, torch.from_numpy(tok).long(), pos, pcfg, backend)
        lt = tm.logits_from_hidden(tparams, ht)
        assert lt.dtype == torch.float32 and lt.shape == (1, tok.shape[1], config.vocab_size)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            tcache[key].numpy(), np.asarray(jcache[key])[..., :hs], **TOL
        )


def test_decode_per_row_positions_matches_jax():
    """A batch-2 decode step with each row at its own position."""
    config = _cfg()
    params = make_params("per_row", config, True)
    pcfg = port_config(config)
    tparams = params_from_numpy(params, "cpu", torch.float32)
    rng = np.random.default_rng(4)
    shape = (config.n_layers, 2, config.n_kv_heads, config.seq_len, config.head_size)
    k0 = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    v0 = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    tok = np.array([[7], [300]], np.int32)
    pos = np.array([4, 61], np.int32)
    hj, jc = jm.forward(params, {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
                        jnp.asarray(tok), jnp.asarray(pos), config)
    tcache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    ht = tm.forward(tparams, tcache, torch.from_numpy(tok).long(), torch.from_numpy(pos), pcfg)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jc["k"]), **TOL)


def test_bf16_forward_close_to_jax():
    """bf16 weights: the two frameworks round at the same places (rmsnorm
    before the weight multiply, silu before the gate product, rope in f32),
    but matmul accumulation differs; logits agree to 3% of their scale."""
    config = _cfg()
    params = make_params("bf16", config, True)
    pcfg = port_config(config)
    jparams = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    tparams = params_from_numpy(params, "cpu", torch.bfloat16)
    tok = np.array([[1, 5, 17, 320, 9]], np.int32)
    hj, _ = jm.forward(jparams, jm.init_cache(config, dtype=jnp.bfloat16), jnp.asarray(tok), 0,
                       config, precision=None)
    lj = np.asarray(jm.logits_from_hidden(jparams, hj, precision=None))
    ht = tm.forward(tparams, tm.init_cache(pcfg, 1, torch.bfloat16), torch.from_numpy(tok).long(), 0, pcfg)
    lt = tm.logits_from_hidden(tparams, ht).numpy()
    assert ht.dtype == torch.bfloat16
    assert np.abs(lt - lj).max() < 3e-2 * np.abs(lj).max()


def test_unported_paths_raise():
    pcfg = port_config(_cfg())
    c = tm.init_cache(pcfg, kv_quant=True)  # ported with slice 4: int8 rows, float32 scales
    assert c["k"].dtype == torch.int8 and c["k_scale"].dtype == torch.float32
    # the shard-blocked layout (ported with slice 17): block s of wqkv is
    # [q_s|k_s|v_s], w1/w3 stay separate, the same bytes as the JAX package's
    params = random_params(_cfg(), seed=1)
    blocked = tm.fuse_layer_params(params_from_numpy(params, "cpu", torch.float32), "torch", shards=2)
    jb = jm.fuse_layer_params({k: jnp.asarray(v) for k, v in params.items()}, "xla", shards=2)
    assert set(blocked) == set(jb)
    for k in ("wqkv", "w1", "w3"):
        np.testing.assert_array_equal(blocked[k].numpy(), np.asarray(jb[k]))
    with pytest.raises(ValueError, match="do not split"):
        tm.fuse_layer_params(params_from_numpy(params, "cpu", torch.float32), shards=3)
    assert tm.layer_keys({"wqkv": None}) == ("rms_att", "wqkv", "wo", "rms_ffn", "w1", "w3", "w2")
    with pytest.raises(ValueError):
        tm.forward({}, {}, torch.zeros(1, 1, dtype=torch.long), 0, pcfg, backend="xla")


# ---- weight bridge, checkpoint and tokenizer copies ----


def test_params_from_numpy():
    params = random_params(_cfg(), seed=1)
    for dtype in (torch.float32, torch.bfloat16):
        tp = params_from_numpy(params, "cpu", dtype)
        assert set(tp) == set(params)
        for k, v in params.items():
            assert tp[k].dtype == dtype and tuple(tp[k].shape) == v.shape
            np.testing.assert_allclose(tp[k].float().numpy(), v, rtol=2**-8, atol=0)


def test_random_params_seeded_layout():
    pcfg = port_config(_cfg())
    a = torch_random_params(pcfg, 5, "cpu", torch.bfloat16)
    b = torch_random_params(pcfg, 5, "cpu", torch.bfloat16)
    c = torch_random_params(pcfg, 6, "cpu", torch.bfloat16)
    ref = random_params(_cfg())
    for k, v in ref.items():
        assert tuple(a[k].shape) == v.shape and a[k].dtype == torch.bfloat16
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["wq"], c["wq"])
    assert torch.equal(a["wcls"], a["tok_emb"].T)  # shared classifier


@pytest.mark.parametrize("shared", [True, False])
def test_checkpoint_roundtrip_across_packages(tmp_path, shared):
    config = _cfg()
    params = random_params(config, seed=2)
    if not shared:
        params = unshare(params, 2)
    jax_save(str(tmp_path / "j.bin"), config, params, shared_weights=shared)
    save_checkpoint(str(tmp_path / "t.bin"), port_config(config), params, shared_weights=shared)
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()
    jc, jp, js = jax_load(str(tmp_path / "t.bin"))
    tc, tp, ts = load_any(str(tmp_path / "j.bin"))
    assert (ts, tc) == (js, port_config(jc))
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])


def test_load_any_refuses_unported_formats(tmp_path):
    """An ak42 file is sniffed and goes to its loader (which refuses a stub
    of one); a directory without ``meta.json`` is no param cache."""
    q8 = tmp_path / "model-q8.bin"
    q8.write_bytes(b"24ka" + b"\0" * 64)
    with pytest.raises(ValueError, match="too short for v2 header"):
        load_any(str(q8))
    with pytest.raises(ValueError, match="not a param cache"):
        load_any(str(tmp_path))


def test_tokenizer_copy_matches():
    jt, tt = JaxTokenizer.from_file(TOKENIZER_BIN, 32000), Tokenizer.from_file(TOKENIZER_BIN, 32000)
    for text in ("Once upon a time", "Hello, world! ñ 你好", " leading space", ""):
        ids = tt.encode(text)
        assert ids == jt.encode(text)
        assert tt.decode(ids) == jt.decode(ids)
        assert tt.decode([1] + ids, first_prev=5) == jt.decode([1] + ids, first_prev=5)
    raw = [i for i, t in enumerate(tt.tokens[:300]) if t.startswith(b"<0x")][:20]
    assert tt.decode(raw) == jt.decode(raw)
