"""The torch port's param-cache directory and random-Q8 tool against the JAX
package's.

``llama2_tpu_torch/io/cache.py`` and ``llama2_tpu/io/cache.py`` write the
same files with the same bytes (``meta.json``, dense ``<name>.npy``,
quantized ``<name>.q.npy`` / ``<name>.scale.npy``), and each loads what the
other wrote. ``llama2_tpu_torch/tools/make_random_q8.py`` draws the JAX tool's
bytes from the same seed. The CLI writes a cache with ``--save-cache`` and
takes a directory as its checkpoint path.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import TOKENIZER_BIN, random_params, tiny_config
from llama2_tpu.io import cache as jcache
from llama2_tpu.io import load_any as jax_load_any
from llama2_tpu.quant import q8 as jq
from llama2_tpu.tools import make_random_q8 as jtool
from llama2_tpu_torch import cli
from llama2_tpu_torch.config import GenerationConfig
from llama2_tpu_torch.config import ModelConfig as TorchModelConfig
from llama2_tpu_torch.io import cache as tcache
from llama2_tpu_torch.io import load_any
from llama2_tpu_torch.quant import q8 as tq
from llama2_tpu_torch.runtime.generator import Generator
from llama2_tpu_torch.tools import make_random_q8 as ttool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_config(c) -> TorchModelConfig:
    return TorchModelConfig(**{f: getattr(c, f) for f in (
        "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size",
        "seq_len", "norm_eps")})


def dir_bytes(path) -> dict:
    return {f: open(os.path.join(path, f), "rb").read() for f in sorted(os.listdir(path))}


def leaves(params: dict) -> dict:
    """Every array of a tree as numpy, quantized leaves as two entries."""
    out = {}
    for k, v in params.items():
        if hasattr(v, "group_size"):
            out[k + ".q"], out[k + ".scale"], out[k + ".group"] = np.asarray(v.q), np.asarray(v.scale), v.group_size
        else:
            out[k] = np.asarray(v)
    return out


def assert_same_tree(a: dict, b: dict):
    la, lb = leaves(a), leaves(b)
    assert list(la) == list(lb)
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k])
        if isinstance(la[k], np.ndarray):
            assert la[k].dtype == lb[k].dtype


@pytest.mark.parametrize("kind", ["fp-shared", "fp-unshared", "q8"])
def test_cache_bytes_and_cross_loading(tmp_path, kind):
    """Both packages write equal bytes for the same tree, and each loads the
    other's directory back to the tree that was saved."""
    config = tiny_config()
    params = random_params(config, seed=5)
    shared = kind == "fp-shared"
    if kind == "fp-unshared":
        params["wcls"] = np.ascontiguousarray(params["wcls"]) * 0.5
    jparams, tparams = params, params
    if kind == "q8":
        jparams, tparams = jq.quantize_params(params, 16), tq.quantize_params(params, 16)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jcache.save_cache(jdir, config, jparams, shared)
    tcache.save_cache(tdir, port_config(config), tparams, shared)
    jb, tb = dir_bytes(jdir), dir_bytes(tdir)
    assert list(jb) == list(tb) and "meta.json" in tb
    assert jb == tb
    if kind == "q8":
        assert "wq.q.npy" in tb and "wq.scale.npy" in tb and "wq.npy" not in tb

    assert tcache.is_cache_dir(jdir) and not tcache.is_cache_dir(str(tmp_path))
    for loader, path, want in ((tcache.load_cache, jdir, tparams), (jcache.load_cache, tdir, jparams),
                               (load_any, jdir, tparams), (jax_load_any, tdir, jparams)):
        got_config, got, got_shared = loader(path)
        assert got_shared == shared
        assert port_config(got_config) == port_config(config)
        assert_same_tree(got, want)
    # the port's loader maps the files: dense leaves stay numpy memmaps, and
    # quantized ones are QuantTensors of CPU tensors over the mapped pages
    _, got, _ = tcache.load_cache(tdir)
    assert isinstance(got["tok_emb"], np.memmap)
    if kind == "q8":
        assert isinstance(got["wq"], tq.QuantTensor) and got["wq"].q.dtype == torch.int8
        assert got["wq"].scale.dtype == torch.float32 and got["wq"].group_size == 16


def test_cache_of_tensors_and_refusals(tmp_path):
    """A tree of torch tensors (as ``params_from_numpy`` or a Generator holds
    it) saves to the bytes of its numpy twin; bf16 and unknown versions are
    refused."""
    config = port_config(tiny_config())
    params = tq.quantize_params(random_params(tiny_config(), seed=6), 16)
    as_tensors = {k: v if isinstance(v, tq.QuantTensor) else torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in params.items()}
    tcache.save_cache(str(tmp_path / "a"), config, params)
    tcache.save_cache(str(tmp_path / "b"), config, as_tensors)
    assert dir_bytes(str(tmp_path / "a")) == dir_bytes(str(tmp_path / "b"))
    with pytest.raises(ValueError, match="bf16"):
        tcache.save_cache(str(tmp_path / "c"), config, {"rms_final": as_tensors["rms_final"].bfloat16()})
    meta = tmp_path / "a" / "meta.json"
    meta.write_text(meta.read_text().replace('"format_version": 1', '"format_version": 9'))
    with pytest.raises(ValueError, match="unsupported cache version"):
        tcache.load_cache(str(tmp_path / "a"))
    with pytest.raises(ValueError, match="not a param cache"):
        load_any(str(tmp_path))


def test_generator_runs_from_a_loaded_cache(tmp_path):
    """The mapped leaves go through the Generator as the in-memory tree does."""
    jconfig = tiny_config()
    config = port_config(jconfig)
    params = tq.quantize_params(random_params(jconfig, seed=7), 16)
    tcache.save_cache(str(tmp_path / "c"), config, params)
    got_config, loaded, _ = load_any(str(tmp_path / "c"))
    gen = GenerationConfig(temperature=0.0, steps=20)
    want = Generator(config, params, backend="cuda", device="cpu").generate([5, 17, 320], gen).tokens
    got = Generator(got_config, loaded, backend="cuda", device="cpu").generate([5, 17, 320], gen).tokens
    assert got == want and len(got) > 3


@pytest.mark.parametrize("seed,group_size", [(0, 64), (3, 32)])
def test_make_random_q8_gives_the_jax_tools_bytes(tmp_path, seed, group_size):
    jconfig = jtool.ModelConfig(**jtool.SHAPES["tiny"])
    tconfig = ttool.ModelConfig(**ttool.SHAPES["tiny"])
    assert ttool.SHAPES == jtool.SHAPES and port_config(jconfig) == tconfig
    assert_same_tree(ttool.random_q8_params(tconfig, group_size, seed),
                     jtool.random_q8_params(jconfig, group_size, seed))
    # and the command lines write the same directory
    assert jtool.main([str(tmp_path / "j"), "--model", "tiny", "--seed", str(seed),
                       "--group-size", str(group_size), "--seq-len", "64"]) == 0
    assert ttool.main([str(tmp_path / "t"), "--model", "tiny", "--seed", str(seed),
                       "--group-size", str(group_size), "--seq-len", "64"]) == 0
    assert dir_bytes(str(tmp_path / "j")) == dir_bytes(str(tmp_path / "t"))
    config, params, shared = load_any(str(tmp_path / "t"))
    assert config.seq_len == 64 and not shared and params["wq"].group_size == group_size


def test_cli_save_cache_then_run_from_the_directory(capfd, tiny_checkpoint, tmp_path):
    """``--save-cache DIR`` writes the quantized tree; a run from ``DIR``
    prints the same bytes and needs no ``--quant``."""
    cdir = str(tmp_path / "cache")
    common = ("-t", "0", "-n", "24", "--platform", "cpu", "-z", TOKENIZER_BIN, "-i", "Once upon", "-v")
    assert cli.main([tiny_checkpoint[0], *common, "--quant", "int8", "--save-cache", cdir]) == 0
    first = capfd.readouterr()
    assert "wrote param cache to" in first.err and tcache.is_cache_dir(cdir)
    assert os.path.exists(os.path.join(cdir, "wq.q.npy"))
    assert cli.main([cdir, *common]) == 0
    second = capfd.readouterr()
    assert second.out == first.out and len(first.out) > 0
    assert "quant: none" in second.err
    # the JAX CLI reads the directory the port wrote
    _, jparams, shared = jax_load_any(cdir)
    assert shared and isinstance(jparams["wq"], jq.QuantTensor)


def test_cli_as_a_module_takes_a_cache_directory(tmp_path):
    """``python -m llama2_tpu_torch DIR`` on a directory from the random-Q8
    tool, also over the int8 KV cache with speculative decoding, and with
    ``--profile d`` (a trace in d, the same bytes); ``--seq-shards 2``, the
    fp sequence-sharded decoder, exits 1 on the Q8 cache with the JAX
    CLI's message."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    cdir = str(tmp_path / "tiny-q8")
    r = subprocess.run([sys.executable, "-m", "llama2_tpu_torch.tools.make_random_q8", cdir,
                        "--model", "tiny", "--seed", "1"], capture_output=True, timeout=240, env=env, cwd=REPO)
    assert r.returncode == 0 and b"wrote tiny" in r.stdout, r.stderr.decode()
    base = [sys.executable, "-m", "llama2_tpu_torch", cdir, "-t", "0", "-n", "12", "--platform", "cpu",
            "-z", TOKENIZER_BIN, "-v"]
    r = subprocess.run(base, capture_output=True, timeout=240, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr.decode()
    assert len(r.stdout) > 0 and b"tokens per second" in r.stderr
    plain = r.stdout
    trace_dir = str(tmp_path / "d")
    for flag in (("--kv-cache", "int8", "--spec", "4"), ("--seq-shards", "2"), ("--profile", trace_dir)):
        r = subprocess.run([*base, *flag], capture_output=True, timeout=240, env=env, cwd=REPO)
        if flag[0] == "--kv-cache":  # ported with slice 4
            assert r.returncode == 0 and len(r.stdout) > 0, r.stderr.decode()
        elif flag[0] == "--profile":  # ported with slice 16
            assert r.returncode == 0 and r.stdout == plain, r.stderr.decode()
            assert [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
        else:  # ported with slice 19: the fp path refuses Q8 weights
            assert r.returncode == 1 and b"--quant int8 is not supported on this path" in r.stderr
