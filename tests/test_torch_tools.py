"""The port's tools and host surface against the JAX package's, on the CPU.

* ``llama2_tpu_torch/tools/perplexity.py`` against ``llama2_tpu/tools/
  perplexity.py`` on the ``tiny_checkpoint`` fixture, fp32 and Q8 (each
  package's ``quantize_params``); chunking invariance, the numpy oracle's
  NLL (as ``tests/test_perplexity.py``), truncation past ``seq_len``, the
  INT8 gate at a small shape, the entry point's exit codes.
* ``llama2_tpu_torch/tools/import_hf.py`` on a tiny ``LlamaForCausalLM``
  built here (as ``tests/test_import_hf.py``), saved as fp32 safetensors, as
  bf16 safetensors in two shards and as ``pytorch_model.bin``: params equal
  to the JAX importer's, its safetensors reader equal to the ``safetensors``
  package's, logits equal to HF's, the ``.bin`` and ``--cache --int8``
  round trips through the port's CLI, the eps warning; it imports neither
  ``safetensors`` nor ``transformers``.
* ``BatchEngine.precompile`` on the CPU, the server's ``--precompile`` and
  the CLI's ``--profile``.
"""

import ast
import json
import os
import re
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import TOKENIZER_BIN, random_params
from llama2_tpu.config import ModelConfig
from llama2_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from llama2_tpu.quant import q8 as jq
from llama2_tpu.tools import import_hf as jhf
from llama2_tpu.tools.perplexity import perplexity as jax_perplexity
from llama2_tpu_torch import cli
from llama2_tpu_torch.config import GenerationConfig
from llama2_tpu_torch.config import ModelConfig as TorchModelConfig
from llama2_tpu_torch.io import load_any
from llama2_tpu_torch.models.llama import forward, init_cache, logits_from_hidden
from llama2_tpu_torch.ops.cuda import build
from llama2_tpu_torch.quant import q8 as tq
from llama2_tpu_torch.runtime import batch_engine as be
from llama2_tpu_torch.runtime.generator import Generator, prepare_params
from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine
from llama2_tpu_torch.tools import import_hf as thf
from llama2_tpu_torch.tools import perplexity as tppl

from oracle import OracleModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def port_config(c) -> TorchModelConfig:
    return TorchModelConfig(**{f: getattr(c, f) for f in (
        "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size",
        "seq_len", "norm_eps")})


def on_cpu(params: dict, backend: str = "cuda") -> dict:
    return prepare_params(params, torch.float32, backend, CPU)


@pytest.fixture(scope="module")
def loaded(tiny_checkpoint):
    path, config, _ = tiny_checkpoint
    _, params, _ = jax_load_checkpoint(path)
    return path, config, params


# ---------------------------------------------------------------- perplexity


@pytest.mark.parametrize("weights", ["fp32", "q8"])
def test_perplexity_matches_jax(loaded, weights):
    """The same numpy weights through both tools: NLL within rel 1e-5, the
    same token count. The JAX tool runs its forward's default, the plain
    route: the port's ``torch`` backend."""
    _, config, params = loaded
    tokens = list(range(2, 40))
    jp = jq.quantize_params(params, 32) if weights == "q8" else params
    tp = tq.quantize_params(params, 32) if weights == "q8" else params
    want = jax_perplexity(config, jp, tokens, chunk=16)
    got = tppl.perplexity(port_config(config), on_cpu(tp, "torch"), tokens, chunk=16, backend="torch")
    assert got["tokens"] == want["tokens"] == len(tokens)
    assert got["nll"] == pytest.approx(want["nll"], rel=1e-5)
    assert got["ppl"] == pytest.approx(want["ppl"], rel=1e-5)


def test_perplexity_matches_oracle_nll(loaded):
    path, config, params = loaded
    tokens = [5, 17, 320, 9, 44]
    out = tppl.perplexity(port_config(config), on_cpu(params), tokens, chunk=3)
    oracle = OracleModel(path)
    feed = [1] + tokens
    nlls = []
    for pos in range(len(feed) - 1):
        logits = oracle.forward(feed[pos], pos).astype(np.float64)
        logp = logits - logits.max()
        logp = logp - np.log(np.exp(logp).sum())
        nlls.append(-logp[feed[pos + 1]])
    assert out["tokens"] == len(nlls)
    assert out["nll"] == pytest.approx(float(np.mean(nlls)), rel=1e-4)


@pytest.mark.parametrize("chunk", [1, 4, 7])
def test_perplexity_chunking_invariance(loaded, chunk):
    _, config, params = loaded
    tokens = list(range(2, 30))
    p = on_cpu(params)
    a = tppl.token_nlls(port_config(config), p, tokens, chunk=chunk)
    b = tppl.token_nlls(port_config(config), p, tokens, chunk=64)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_perplexity_truncates_past_seq_len(loaded):
    """``[BOS] + tokens`` is cut to seq_len (96) positions: 95 tokens scored,
    the same as the first 95 tokens alone, and as the JAX tool."""
    _, config, params = loaded
    tokens = [int(t) for t in np.random.default_rng(3).integers(3, config.vocab_size, 130)]
    p = on_cpu(params)
    got = tppl.perplexity(port_config(config), p, tokens, chunk=64)
    cut = tppl.perplexity(port_config(config), p, tokens[: config.seq_len - 1], chunk=64)
    want = jax_perplexity(config, params, tokens, chunk=64)
    assert got["tokens"] == cut["tokens"] == want["tokens"] == config.seq_len - 1
    assert got["nll"] == cut["nll"]
    assert got["nll"] == pytest.approx(want["nll"], rel=1e-5)


def test_int8_perplexity_gate_small_shape():
    """The quality gate at a small shape (JAX's is TinyLlama-1.1B-shaped,
    too slow for the CPU): random Llama-scale weights, a seeded corpus,
    Q8 on ``cuda-accurate`` (the plain version here) within |dNLL| < 5e-3 of
    the fp32 weights it was quantized from."""
    config = ModelConfig(dim=256, hidden_dim=704, n_layers=4, n_heads=8, n_kv_heads=2,
                         vocab_size=512, seq_len=160)
    params = random_params(config, seed=5, scale=0.02)
    corpus = [int(t) for t in np.random.default_rng(7).integers(3, config.vocab_size, 150)]
    tc = port_config(config)
    fp = tppl.perplexity(tc, on_cpu(params, "cuda-accurate"), corpus, 64, "cuda-accurate")
    q8 = tppl.perplexity(tc, on_cpu(tq.quantize_params(params), "cuda-accurate"), corpus, 64, "cuda-accurate")
    assert fp["tokens"] == q8["tokens"] == 150
    assert abs(q8["nll"] - fp["nll"]) < 5e-3, (fp, q8)


@pytest.mark.parametrize("argv,rc,text", [
    ([], 1, "python -m llama2_tpu_torch.tools.perplexity"),
    (["ck.bin"], 1, "python -m llama2_tpu_torch.tools.perplexity"),
    (["ck.bin", "-i", "a", "--bogus"], 1, "unknown argument --bogus"),
    (["ck.bin", "-i"], 1, "missing argument for -i"),
    (["ck.bin", "-i", "a", "--chunk", "0"], 1, "--chunk must be a positive integer"),
    (["ck.bin", "-i", "a", "--platform", "tpu"], 1, "--platform must be cpu or gpu"),
])
def test_perplexity_entry_point_exit_codes(capsys, argv, rc, text):
    assert tppl.main(argv) == rc
    assert text in capsys.readouterr().err


def test_perplexity_entry_point(capsys, loaded, tmp_path):
    """``--platform cpu`` scores the text; the default platform needs a card;
    ``-f`` reads a file."""
    path, config, params = loaded
    text = "a b c d e f"
    if not torch.cuda.is_available():
        assert tppl.main([path, "-z", TOKENIZER_BIN, "-i", text]) == 1
        assert "--platform cpu" in capsys.readouterr().err
    f = tmp_path / "text.txt"
    f.write_text(text, encoding="utf-8")
    for src in (["-i", text], ["-f", str(f)]):
        assert tppl.main([path, "-z", TOKENIZER_BIN, *src, "--chunk", "4", "--platform", "cpu"]) == 0
        line = capsys.readouterr().out.strip()
        m = re.fullmatch(r"tokens: (\d+)  nll: ([\d.]+)  ppl: ([\d.]+)", line)
        assert m, line
        from llama2_tpu_torch.tokenizer.tokenizer import Tokenizer

        ids = Tokenizer.from_file(TOKENIZER_BIN, config.vocab_size).encode(text)
        want = tppl.perplexity(port_config(config), on_cpu(params), ids, chunk=4)
        assert int(m.group(1)) == want["tokens"] and float(m.group(2)) == pytest.approx(want["nll"], abs=1e-4)


# ---------------------------------------------------------------- import_hf


HF_CONFIG = dict(hidden_size=64, intermediate_size=172, num_hidden_layers=3, num_attention_heads=4,
                 num_key_value_heads=2, vocab_size=512, max_position_embeddings=96,
                 tie_word_embeddings=False, rms_norm_eps=1e-5)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """One tiny LlamaForCausalLM saved four ways: fp32 safetensors, bf16
    safetensors in two shards, fp32 ``pytorch_model.bin``, and bf16
    ``pytorch_model.bin`` (the JAX importer's reading of the bf16 weights)."""
    os.environ.setdefault("USE_TF", "0")  # transformers' TensorFlow import costs seconds and nothing here uses it
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(**HF_CONFIG)).eval()
    root = tmp_path_factory.mktemp("hf")
    dirs = {k: str(root / k) for k in ("st-f32", "st-bf16", "bin-f32", "bin-bf16")}
    model.save_pretrained(dirs["st-f32"], safe_serialization=True)
    model.save_pretrained(dirs["bin-f32"], safe_serialization=False)
    half = transformers.LlamaForCausalLM(transformers.LlamaConfig(**HF_CONFIG)).eval()
    half.load_state_dict(model.state_dict())
    half = half.to(torch.bfloat16)
    half.save_pretrained(dirs["st-bf16"], safe_serialization=True, max_shard_size="100KB")
    half.save_pretrained(dirs["bin-bf16"], safe_serialization=False)
    return dirs, model


def test_hf_bf16_safetensors_come_in_shards(hf_dirs):
    dirs, _ = hf_dirs
    shards = [f for f in os.listdir(dirs["st-bf16"]) if f.endswith(".safetensors")]
    assert len(shards) >= 2


@pytest.mark.parametrize("src,jax_src", [("st-f32", "bin-f32"), ("bin-f32", "bin-f32"), ("st-bf16", "bin-bf16")])
def test_hf_import_params_equal_jax(hf_dirs, src, jax_src):
    """Exact: the port's params from each format equal the JAX importer's
    (which reads safetensors through the ``safetensors`` package, or the
    same weights' ``.bin``)."""
    dirs, _ = hf_dirs
    config, params, shared = thf.import_hf(dirs[src])
    jconfig, jparams, jshared = jhf.import_hf(dirs[jax_src])
    assert port_config(jconfig) == config and shared == jshared is False
    assert sorted(params) == sorted(jparams)
    for k in params:
        assert params[k].dtype == np.float32 and params[k].flags.c_contiguous
        np.testing.assert_array_equal(params[k], jparams[k], err_msg=k)


@pytest.mark.parametrize("fmt", ["st-f32", "st-bf16"])
def test_safetensors_reader_matches_the_package(hf_dirs, fmt):
    import safetensors.numpy
    import safetensors.torch

    dirs, _ = hf_dirs
    for f in sorted(os.listdir(dirs[fmt])):
        if not f.endswith(".safetensors"):
            continue
        path = os.path.join(dirs[fmt], f)
        got = thf.load_safetensors(path)
        want = (safetensors.numpy.load_file(path) if fmt == "st-f32"
                else {k: v.float().numpy() for k, v in safetensors.torch.load_file(path).items()})
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_safetensors_reader_dtypes_and_refusal(tmp_path):
    """F16 stays F16, ``__metadata__`` is skipped, and an integer tensor
    raises rather than being read as a float."""
    import safetensors.numpy

    a = np.arange(12, dtype=np.float16).reshape(3, 4)
    path = str(tmp_path / "f16.safetensors")
    safetensors.numpy.save_file({"a": a}, path, metadata={"format": "np"})
    got = thf.load_safetensors(path)
    assert list(got) == ["a"] and got["a"].dtype == np.float16
    np.testing.assert_array_equal(got["a"], a)
    bad = str(tmp_path / "i32.safetensors")
    safetensors.numpy.save_file({"n": np.arange(4, dtype=np.int32)}, bad)
    with pytest.raises(ValueError, match="I32"):
        thf.load_safetensors(bad)


@pytest.mark.parametrize("t0", [0, 2])
def test_hf_import_logits_match_hf(hf_dirs, t0):
    """The port's ``forward`` on the imported weights reproduces HF's logits
    (``tests/test_import_hf.py``'s tolerance): the whole segment at once, or
    its first ``t0`` tokens then one token at a time through the cache."""
    dirs, model = hf_dirs
    config, params, _ = thf.import_hf(dirs["st-f32"])
    tokens = np.array([[1, 5, 42, 300, 7, 12]], np.int64)
    with torch.no_grad():
        want = model(torch.from_numpy(tokens)).logits.numpy()
    p = on_cpu(params, "torch")
    cache = init_cache(config, 1)
    segs = [(0, tokens.shape[1])] if t0 == 0 else [(0, t0)] + [(t, t + 1) for t in range(t0, tokens.shape[1])]
    outs = []
    for a, b in segs:
        hidden = forward(p, cache, torch.from_numpy(tokens[:, a:b]), a, config, "torch")
        outs.append(logits_from_hidden(p, hidden, "torch").numpy())
    got = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_hf_import_cli_round_trips(hf_dirs, tmp_path, capfd):
    """``.bin`` and ``--cache --int8`` through the port's CLI: the INT8 cache
    prints the bytes of the ``.bin`` with ``--quant int8``; the ``.bin``
    loads the imported params exactly."""
    dirs, _ = hf_dirs
    out_bin, out_cache = str(tmp_path / "imported.bin"), str(tmp_path / "cache")
    assert thf.main([dirs["st-bf16"], out_bin]) == 0
    assert thf.main([dirs["st-bf16"], out_cache, "--cache", "--int8"]) == 0
    capfd.readouterr()
    config, params, shared = load_any(out_bin)
    _, want, _ = thf.import_hf(dirs["st-bf16"])
    assert not shared and config.vocab_size == 512
    for k in want:
        np.testing.assert_array_equal(params[k], want[k], err_msg=k)
    cconfig, cparams, _ = load_any(out_cache)
    assert isinstance(cparams["wq"], tq.QuantTensor) and cconfig.norm_eps == 1e-5
    base = ["-t", "0", "-n", "16", "--platform", "cpu", "-z", TOKENIZER_BIN, "-i", "a b"]
    assert cli.main([out_cache, *base]) == 0
    from_cache = capfd.readouterr().out
    assert cli.main([out_bin, *base, "--quant", "int8"]) == 0
    assert capfd.readouterr().out == from_cache and len(from_cache) > 0


def test_hf_import_eps_warning_and_int8_needs_cache(tmp_path, capsys):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.LlamaConfig(**{**HF_CONFIG, "num_hidden_layers": 1, "rms_norm_eps": 1e-6})
    d = str(tmp_path / "hf")
    transformers.LlamaForCausalLM(cfg).eval().save_pretrained(d)
    assert thf.main([d, str(tmp_path / "x.bin"), "--int8"]) == 1
    assert "--int8 requires --cache" in capsys.readouterr().err
    assert thf.main([d, str(tmp_path / "x.bin")]) == 0
    assert "cannot store rms_norm_eps=1e-06" in capsys.readouterr().err
    assert thf.main([d, str(tmp_path / "c"), "--cache"]) == 0
    assert "warning" not in capsys.readouterr().err
    assert load_any(str(tmp_path / "c"))[0].norm_eps == 1e-6
    assert thf.main([d]) == 1


def test_importer_imports_neither_safetensors_nor_transformers():
    with open(thf.__file__) as f:
        tree = ast.parse(f.read())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {m for m in mods if m and m.split(".")[0] in ("safetensors", "transformers")}, mods


# ---------------------------------------------------------------- precompile, --profile


def _engine_streams(config, params, precompile: bool) -> list:
    eng = be.BatchEngine(config, params, batch_size=2, backend="cuda", device="cpu", spec_window=4)
    if precompile:
        assert eng.precompile(prompt_lens=(16, 128), stochastic=(False, True), spec=True) == 0
    gens = [GenerationConfig(temperature=0.0, steps=30), GenerationConfig(temperature=0.8, steps=30, seed=3)]
    queues = [eng.submit([5, 17, 320, 9], g) for g in gens]
    eng.run_until_idle()
    return [q.get(timeout=60).tokens for q in queues]


def test_precompile_on_the_cpu_changes_nothing(loaded):
    """On CPU tensors there is nothing to build: precompile returns 0 and the
    streams equal an engine's without it."""
    _, config, params = loaded
    tc = port_config(config)
    assert _engine_streams(tc, params, True) == _engine_streams(tc, params, False)


def test_precompile_paged_engine_raises(loaded):
    _, config, params = loaded
    eng = PagedBatchEngine(port_config(config), params, batch_size=2, page_size=8, n_pages=24,
                           backend="cuda", device="cpu")
    with pytest.raises(NotImplementedError):
        eng.precompile(prompt_lens=(16,))


@pytest.mark.parametrize("lens,chunks", [((), []), ((16,), [1, 8]), ((16, 128), [1, 8, 128]),
                                         ((200,), [1, 8, 32, 128]), ((0,), [1])])
def test_precompile_chunks_are_the_prefill_decomposition(lens, chunks):
    """``[BOS] + prompt`` in PREFILL_CHUNKS pieces, as the engine prefills it
    (and as the JAX engine's precompile decomposes it)."""
    assert be._chunks(lens) == chunks


@pytest.mark.parametrize("weights,backend,kv_quant,want", [
    ("q8", "cuda", False, ["prefill_attention", "decode_attention", "quant_matmul", "mlp_block"]),
    ("q8", "cuda", True, ["attention_q8", "quant_matmul", "mlp_block"]),
    ("q8", "cuda-accurate", False, ["prefill_attention", "decode_attention", "quant_matmul"]),
    ("q8", "cuda-accurate", True, ["attention_q8", "quant_matmul"]),
    ("fp", "cuda", False, ["prefill_attention", "decode_attention"]),
    ("fp", "cuda", True, ["attention_q8"]),
    ("q8", "torch", False, []),
])
def test_kernel_libraries_by_route(loaded, weights, backend, kv_quant, want):
    _, _, params = loaded
    p = tq.quantize_params(params, 32) if weights == "q8" else params
    assert be.kernel_libraries(p, backend, kv_quant) == want
    assert set(want) <= set(build_sources())


def build_sources() -> tuple:
    from llama2_tpu_torch.ops.cuda import SOURCES

    return SOURCES


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A build that cannot run raises; nothing falls back."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_nvcc", lambda: (_ for _ in ()).throw(build.KernelBuildError("nvcc not found")))
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(build.KernelBuildError):
        build.build_all(["swiglu"])
    with pytest.raises(build.KernelBuildError):
        build.start_builds(["swiglu"])
    assert build._pending == {}


def test_server_precompile_serves_on_the_cpu(tiny_checkpoint):
    """``--precompile 16``: the dense engine reports what it precompiled (0
    programs on the CPU) and serves the Generator's greedy tokens."""
    path, _, _ = tiny_checkpoint
    cmd = [sys.executable, "-m", "llama2_tpu_torch.runtime.server", path, "-z", TOKENIZER_BIN,
           "--platform", "cpu", "--port", "0", "--precompile", "16,4", "--kernels", "cuda", "--batch-size", "2"]
    proc = subprocess.Popen(cmd, cwd=REPO, stderr=subprocess.PIPE, text=True)
    try:
        first = proc.stderr.readline()
        assert re.match(r"precompiled 0 programs in [\d.]+s", first), first
        m = re.search(r"http://[\d.]+:\d+", proc.stderr.readline())
        assert m
        import urllib.request

        req = urllib.request.Request(m.group(0) + "/generate", data=json.dumps(
            {"prompt": "a b", "temperature": 0.0, "steps": 21}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        config, params, _ = load_any(path)
        from llama2_tpu_torch.tokenizer.tokenizer import Tokenizer

        tok = Tokenizer.from_file(TOKENIZER_BIN, config.vocab_size)
        want = Generator(config, params, backend="torch", device="cpu").generate(
            tok.encode("a b"), GenerationConfig(temperature=0.0, steps=21)).tokens
        assert body["tokens"] == want
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stderr.close()


def test_cli_profile_writes_a_trace(tiny_checkpoint, tmp_path, capfd):
    """``--profile DIR`` on the CPU: DIR is made, holds a Chrome trace of the
    run's operators, and stdout is the run's without the flag."""
    path, _, _ = tiny_checkpoint
    base = [path, "-t", "0", "-n", "12", "--platform", "cpu", "-z", TOKENIZER_BIN, "-i", "a b"]
    assert cli.main(base) == 0
    want = capfd.readouterr().out
    d = tmp_path / "trace" / "d"
    assert cli.main([*base, "--profile", str(d), "-v"]) == 0
    got = capfd.readouterr()
    assert got.out == want and len(want) > 0
    traces = [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1 and f"wrote profile trace to {d / traces[0]}" in got.err
    with open(d / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::embedding" or e.get("name") == "aten::index" for e in events)
    assert not any(e.get("cat") == "kernel" for e in events)  # the CPU run has no device events
