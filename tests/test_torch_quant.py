"""The torch port's INT8 (Q8) quantizer, ak42 checkpoint format, format
sniffing and converter against the JAX package.

Quantization runs in numpy with the same operations in both packages, so the
int8 values and the float32 scales must be equal bit for bit, and so must the
bytes of an ak42 file either package writes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_params
from llama2_tpu.config import ModelConfig
from llama2_tpu.io.checkpoint import save_checkpoint as jax_save_v0
from llama2_tpu.io.quantized import load_quantized_checkpoint as jax_load_q8
from llama2_tpu.io.quantized import save_quantized_checkpoint as jax_save_q8
from llama2_tpu.quant import convert as jax_convert
from llama2_tpu.quant import q8 as jq
from llama2_tpu_torch.config import ModelConfig as TorchModelConfig
from llama2_tpu_torch.io import load_any
from llama2_tpu_torch.io.convert import params_from_numpy, random_q8_params
from llama2_tpu_torch.io.quantized import load_quantized_checkpoint, save_quantized_checkpoint
from llama2_tpu_torch.quant import convert
from llama2_tpu_torch.quant import q8 as tq


def tiny_config(**kw) -> ModelConfig:
    base = dict(dim=64, hidden_dim=172, n_layers=3, n_heads=4, n_kv_heads=2,
                vocab_size=512, seq_len=96)
    base.update(kw)
    return ModelConfig(**base)


def port_config(c) -> TorchModelConfig:
    return TorchModelConfig(**{f: getattr(c, f) for f in (
        "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size",
        "seq_len", "norm_eps")})


@pytest.mark.parametrize(
    "shape,G",
    [((256, 96), 64), ((3, 128, 40), 32), ((2, 2, 64, 8), 16), ((280, 128), 8)],
)
def test_quantize_bytes_equal_jax(shape, G):
    rng = np.random.default_rng(sum(shape) + G)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., :G, 0] = 0.0  # an all-zero group: the zero-scale guard
    w[..., 0, 1] = 0.5 * 127.0  # exact .5 ratios: ties-to-even
    w[..., 1, 1] = 127.0
    jt, tt = jq.quantize(w, G), tq.quantize(w, G)
    assert tt.q.dtype == torch.int8 and tt.scale.dtype == torch.float32
    assert tt.group_size == G and tuple(tt.shape) == shape
    assert tt.q.numpy().tobytes() == np.asarray(jt.q).tobytes()
    assert tt.scale.numpy().tobytes() == np.asarray(jt.scale).tobytes()
    assert tq.quantize(torch.from_numpy(w), G).q.equal(tt.q)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tq.dequantize(tt, dtype)
        want = np.asarray(jq.dequantize(jt, jdtype).astype(jnp.float32))
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_quantize_rejects_ragged_groups_and_moves():
    with pytest.raises(ValueError, match="not divisible"):
        tq.quantize(np.ones((100, 8), np.float32), 64)
    t = tq.quantize(np.ones((2, 64, 8), np.float32), 32)
    moved = t.to("cpu")
    assert moved.device.type == "cpu" and moved.group_size == 32
    assert tuple(t[1].shape) == (64, 8) and tuple(t[1].scale.shape) == (2, 8)


def test_quantize_params_gcd_rule_matches_jax():
    config = tiny_config(dim=48, hidden_dim=136, n_heads=4, n_kv_heads=2)
    params = random_params(config, seed=5)
    jp, tp = jq.quantize_params(params, 32), tq.quantize_params(params, 32)
    assert tq.QUANTIZED_PARAMS == jq.QUANTIZED_PARAMS
    assert set(tp) == set(jp)
    for k in tq.QUANTIZED_PARAMS:
        assert tp[k].group_size == jp[k].group_size
        assert tp[k].q.numpy().tobytes() == np.asarray(jp[k].q).tobytes()
        assert tp[k].scale.numpy().tobytes() == np.asarray(jp[k].scale).tobytes()
    assert tp["wq"].group_size == 16 and tp["w2"].group_size == 8  # gcd(48,32), gcd(136,32)
    assert tp["rms_att"] is params["rms_att"] and tp["tok_emb"] is params["tok_emb"]


@pytest.mark.parametrize("shared", [True, False])
def test_ak42_files_cross_load_and_savers_agree(tmp_path, shared):
    config = tiny_config(hidden_dim=160)  # every in-features a multiple of G
    G = 32
    params = random_params(config, seed=9)
    if not shared:
        rng = np.random.default_rng(1)
        params["wcls"] = 0.1 * rng.standard_normal(params["wcls"].shape).astype(np.float32)
    jpath, tpath = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jax_save_q8(jpath, config, jq.quantize_params(params, G), shared, G)
    save_quantized_checkpoint(tpath, port_config(config), tq.quantize_params(params, G), shared, G)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()

    jc, jp, js = jax_load_q8(tpath)  # the JAX loader on the port's file
    tc, tp, ts = load_any(jpath)  # the port's sniffing loader on the JAX file
    assert (tc, ts) == (port_config(jc), js) and ts == shared
    assert set(tp) == set(jp)
    for k, v in jp.items():
        if isinstance(v, jq.QuantTensor):
            assert isinstance(tp[k], tq.QuantTensor) and tp[k].group_size == v.group_size
            np.testing.assert_array_equal(tp[k].q.numpy(), np.asarray(v.q))
            np.testing.assert_array_equal(tp[k].scale.numpy(), np.asarray(v.scale))
        else:
            np.testing.assert_array_equal(tp[k], np.asarray(v))
    # a loaded tree saves back to the same bytes, through tensors as well
    again = str(tmp_path / "again.bin")
    save_quantized_checkpoint(again, tc, params_from_numpy(tp, "cpu"), ts, G)
    assert open(again, "rb").read() == open(jpath, "rb").read()


def test_ak42_loader_and_saver_reject():
    config = tiny_config()
    qp = tq.quantize_params(random_params(config, seed=2), 32)
    with pytest.raises(ValueError, match="group size"):
        save_quantized_checkpoint("/dev/null", port_config(config), qp, True, 64)


def test_ak42_loader_rejects_bad_files(tmp_path):
    short = tmp_path / "short.bin"
    short.write_bytes(b"24ka" + b"\0" * 64)
    with pytest.raises(ValueError, match="too short"):
        load_any(str(short))
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"24ka" + (3).to_bytes(4, "little") + b"\0" * 300)
    with pytest.raises(ValueError, match="version"):
        load_quantized_checkpoint(str(bad))
    bad.write_bytes(b"\0" * 300)
    with pytest.raises(ValueError, match="magic"):
        load_quantized_checkpoint(str(bad))


def test_convert_cli_matches_jax(tmp_path, capsys):
    config = tiny_config(dim=48, hidden_dim=136, n_heads=4, n_kv_heads=2)
    src = str(tmp_path / "m.bin")
    jax_save_v0(src, config, random_params(config, seed=3), shared_weights=True)
    assert jax_convert.main([src, str(tmp_path / "j8.bin"), "--group-size", "32"]) == 0
    assert convert.main([src, str(tmp_path / "t8.bin"), "--group-size=32"]) == 0
    assert "group size 32 does not divide dims; using 8" in capsys.readouterr().err
    assert (tmp_path / "j8.bin").read_bytes() == (tmp_path / "t8.bin").read_bytes()
    assert convert.main([src]) == 1  # usage


def test_params_from_numpy_quantized_entries():
    w = np.random.default_rng(0).standard_normal((2, 64, 8)).astype(np.float32)
    t = tq.quantize(w, 32)
    tree = {"wq": (t.q.numpy(), t.scale.numpy(), 32), "wo": t, "rms": np.ones(8, np.float32)}
    out = params_from_numpy(tree, "cpu", torch.bfloat16)
    for k in ("wq", "wo"):
        assert isinstance(out[k], tq.QuantTensor) and out[k].group_size == 32
        assert out[k].q.dtype == torch.int8 and out[k].scale.dtype == torch.float32
        assert out[k].q.equal(t.q) and out[k].scale.equal(t.scale)
    assert out["rms"].dtype == torch.bfloat16


def test_random_q8_params_seeded_layout():
    pcfg = port_config(tiny_config(dim=64, hidden_dim=128, n_heads=4, n_kv_heads=2))
    a = random_q8_params(pcfg, 5, "cpu", torch.bfloat16, group_size=32)
    b = random_q8_params(pcfg, 5, "cpu", torch.bfloat16, group_size=32)
    c = random_q8_params(pcfg, 6, "cpu", torch.bfloat16, group_size=32)
    L, D, HD, V, KV = pcfg.n_layers, 64, 128, pcfg.vocab_size, pcfg.kv_dim
    shapes = {"wq": (L, D, D), "wk": (L, D, KV), "wv": (L, D, KV), "wo": (L, D, D),
              "w1": (L, D, HD), "w2": (L, HD, D), "w3": (L, D, HD), "wcls": (D, V)}
    for k, shape in shapes.items():
        assert isinstance(a[k], tq.QuantTensor) and tuple(a[k].shape) == shape
        assert tuple(a[k].scale.shape) == (*shape[:-2], shape[-2] // 32, shape[-1])
        assert a[k].q.equal(b[k].q) and a[k].scale.equal(b[k].scale)
        assert int(a[k].q.min()) >= -127
    assert not a["wq"].q.equal(c["wq"].q)
    assert a["tok_emb"].dtype == a["rms_att"].dtype == torch.bfloat16
    # effective weight std near Llama's initializer (0.02)
    assert 0.015 < float(tq.dequantize(a["w1"]).std()) < 0.025
    with pytest.raises(ValueError, match="not divisible"):
        random_q8_params(pcfg, 5, "cpu", group_size=48)
