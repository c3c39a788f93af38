"""The torch port's Generator and CLI against the JAX package, and the
port's independence from it.

* ``Generator(device="cpu")`` is token-identical to the JAX ``Generator`` at
  temperature 0 on fp32 parity-matrix configs, for the prompts of
  ``tests/test_parity_matrix.py``, with and without ``prefill_chunk``, and on
  the echo-only and BOS-in-prompt paths.
* The CLI parse surface mirrors ``tests/test_cli.py``; unported flags exit 1
  (``--quant int8`` is ported: ``tests/test_torch_generate_q8.py``).
* ``python -m llama2_tpu_torch ... --platform cpu`` prints the same bytes as
  ``python -m llama2_tpu ... --platform cpu``.
* No module of ``llama2_tpu_torch`` imports ``jax`` or ``llama2_tpu``.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

from conftest import TOKENIZER_BIN, random_params
from llama2_tpu import cli as jax_cli
from llama2_tpu.config import GenerationConfig as JaxGenerationConfig
from llama2_tpu.config import ModelConfig
from llama2_tpu.runtime.generator import Generator as JaxGenerator
from llama2_tpu_torch import cli
from llama2_tpu_torch.config import GenerationConfig
from llama2_tpu_torch.config import ModelConfig as TorchModelConfig
from llama2_tpu_torch.runtime.generator import Generator, resolve_device, uniform_draw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "llama2_tpu_torch")


def _cfg(**kw) -> ModelConfig:
    base = dict(dim=64, hidden_dim=172, n_layers=3, n_heads=4, n_kv_heads=2,
                vocab_size=512, seq_len=96)
    base.update(kw)
    return ModelConfig(**base)


def port_config(c: ModelConfig) -> TorchModelConfig:
    return TorchModelConfig(**{f: getattr(c, f) for f in (
        "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size",
        "seq_len", "norm_eps")})


CONFIGS = {
    "mqa": _cfg(n_kv_heads=1),
    "mha_odd_dim": _cfg(dim=60, n_heads=6, n_kv_heads=6, hidden_dim=144),
}
# (prompt, steps, prefill_chunk): the parity matrix's two prompts, chunked
# prefill, a chunk of 1 (token-at-a-time), the echo-only path (prompt at
# least `steps` long) and a BOS inside the prompt
CASES = [
    ([], 56, None),
    ([5, 17, 320, 9], 40, None),
    ([5, 17, 320, 9, 44, 2, 100], 40, 3),
    ([5, 17, 320, 9], 30, 1),
    ([5, 17, 320, 9, 44, 2, 100, 7], 6, None),
    ([5, 17, 320, 9, 44, 2, 100, 7], 6, 4),
    ([5, 17, 1, 320, 9], 40, None),
]


@pytest.fixture(scope="module")
def generators():
    out = {}
    for name, config in CONFIGS.items():
        params = random_params(config, seed=len(name))
        out[name] = (
            JaxGenerator(config, params),
            Generator(port_config(config), params, device="cpu"),
        )
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("prompt,steps,chunk", CASES)
def test_generate_token_identical_to_jax(generators, name, prompt, steps, chunk):
    jg, tg = generators[name]
    want = jg.generate(prompt, JaxGenerationConfig(temperature=0.0, steps=steps), prefill_chunk=chunk)
    got = tg.generate(prompt, GenerationConfig(temperature=0.0, steps=steps), prefill_chunk=chunk)
    assert got.tokens == want.tokens
    assert got.prompt_len == want.prompt_len == len(prompt)


def test_sampled_stream_is_a_function_of_the_seed(generators):
    _, tg = generators["mqa"]
    gen = GenerationConfig(temperature=0.9, top_p=0.9, steps=40, seed=11)
    a = tg.generate([5, 17], gen).tokens
    assert a == tg.generate([5, 17], gen).tokens
    other = tg.generate([5, 17], GenerationConfig(temperature=0.9, top_p=0.9, steps=40, seed=12))
    assert other.tokens != a
    multi = tg.generate([5, 17], GenerationConfig(temperature=1.0, top_p=1.0, steps=40, seed=11))
    assert len(multi.tokens) >= 2 and multi.tokens[:2] == [5, 17]
    assert 0.0 <= uniform_draw(11, 3) < 1.0 and uniform_draw(11, 3) == uniform_draw(11, 3)
    assert uniform_draw(11, 3) != uniform_draw(11, 4) != uniform_draw(12, 4)


def test_entry_points_need_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        Generator(port_config(_cfg()), random_params(_cfg()))
    assert resolve_device("cpu") == torch.device("cpu")


def test_generator_refuses_unported_options():
    params = random_params(_cfg())
    for kw in ({"speculative": 4}, {"kv_quant": True}, {"backend": "pallas"}):
        with pytest.raises((NotImplementedError, ValueError)):
            Generator(port_config(_cfg()), params, device="cpu", **kw)


# ---- CLI ----


def run_main(capsys, *argv):
    """``cli.main`` in process; returns (exit code, stdout, stderr)."""
    try:
        rc = cli.main(list(argv))
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize(
    "argv,rc,where,text",
    [
        ((), 0, "out", "Usage:"),  # no args
        (("-h",), 0, "out", "--temperature"),
        (("ck.bin", "--bogus"), 0, "err", "unknown argument"),
        (("ck.bin", "-t"), 1, "err", "missing argument"),
        (("a.bin", "b.bin"), 1, "err", "multiple checkpoint paths"),
        (("ck.bin", "-n", "x"), 1, "err", "unable to parse --seq-len"),
        (("ck.bin", "--dtype", "f16"), 1, "err", "unable to parse --dtype"),
        (("ck.bin", "--kernels", "pallas"), 1, "err", "unable to parse --kernels"),
        (("ck.bin", "--platform", "tpu"), 1, "err", "unable to parse --platform"),
        (("ck.bin", "--prefill-chunk", "0"), 1, "err", "--prefill-chunk must be >= 1"),
        (("ck.bin", "--quant", "int4"), 1, "err", "unable to parse --quant"),
        (("ck.bin", "--kv-cache", "int8"), 1, "err", "not yet ported to the torch package"),
        (("ck.bin", "--spec", "4"), 1, "err", "not yet ported to the torch package"),
        (("ck.bin", "--seq-shards", "2"), 1, "err", "not yet ported to the torch package"),
        (("ck.bin", "--save-cache", "d"), 1, "err", "not yet ported to the torch package"),
        (("ck.bin", "--profile", "d"), 1, "err", "not yet ported to the torch package"),
    ],
)
def test_cli_parse_surface(capsys, argv, rc, where, text):
    got_rc, out, err = run_main(capsys, *argv)
    assert got_rc == rc
    assert text in (out if where == "out" else err)
    if argv[-1:] == ("--bogus",):
        assert "Usage:" in out


def test_cli_default_platform_needs_a_card(capsys, tiny_checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default platform is valid")
    rc, _, err = run_main(capsys, tiny_checkpoint[0], "-n", "4")
    assert rc == 1 and "--platform cpu" in err


def test_cli_bytes_match_jax_cli(capsysbinary, tiny_checkpoint):
    """``python -m llama2_tpu_torch`` as a subprocess against the JAX CLI's
    ``main`` (what ``python -m llama2_tpu`` runs), in process: JAX is already
    imported and pinned to the CPU here."""
    args = (tiny_checkpoint[0], "-t", "0", "-n", "24", "--platform", "cpu", "-z", TOKENIZER_BIN)
    assert jax_cli.main(list(args)) == 0
    want = capsysbinary.readouterr().out
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    tr = subprocess.run(
        [sys.executable, "-m", "llama2_tpu_torch", *args, "-v"],
        capture_output=True, timeout=240, env=env, cwd=REPO,
    )
    assert tr.returncode == 0, tr.stderr.decode()
    assert tr.stdout == want and len(want) > 0
    assert b"tokens per second" in tr.stderr and b"device: cpu" in tr.stderr


# ---- independence from the JAX package ----


def test_port_imports_no_jax():
    offenders = []
    for root, _, files in os.walk(PORT):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(root, fname)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                for n in names:
                    top = n.split(".")[0]
                    if top in ("jax", "jaxlib", "llama2_tpu"):
                        offenders.append(f"{os.path.relpath(path, REPO)}: {n}")
    assert not offenders, offenders
    chip_smoke = os.path.join(REPO, "chip_smoke.py")
    with open(chip_smoke) as f:
        tree = ast.parse(f.read())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {m for m in mods if m and m.split(".")[0] in ("jax", "llama2_tpu")}
