"""Exact speculative decoding and the int8 KV cache in the torch port's
``Generator`` and CLI.

The contracts of ``tests/test_speculative.py`` and
``tests/test_kv_quant.py::test_generation_with_q8_cache_tracks_fp32``, on the
port (``backend="torch"``, the plain path, fp32 on the CPU): speculative
streams equal plain greedy streams token for token, sampled modes ignore the
option, and both compose with the int8 cache. Against the JAX package: the
port's ``Generator(kv_quant=True)`` at temperature 0 gives the JAX
``Generator(kv_quant=True)``'s tokens (``torch`` <-> ``xla``), and the CLI's
``--kv-cache int8`` and ``--spec 4`` print the JAX CLI's bytes.
"""

import os
import subprocess
import sys

import pytest
import torch

from conftest import TOKENIZER_BIN, random_params, tiny_config
from llama2_tpu import cli as jax_cli
from llama2_tpu.config import GenerationConfig as JaxGenerationConfig
from llama2_tpu.runtime.generator import Generator as JaxGenerator
from llama2_tpu_torch.config import GenerationConfig
from llama2_tpu_torch.config import ModelConfig as TorchModelConfig
from llama2_tpu_torch.runtime.generator import Generator, prompt_lookup


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread here: beside the JAX runtime's threads, and the
    other test workers', more threads only slow these small shapes down."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_config(c) -> TorchModelConfig:
    return TorchModelConfig(**{f: getattr(c, f) for f in (
        "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size", "seq_len", "norm_eps")})


@pytest.fixture(scope="module")
def model():
    config = tiny_config()
    return port_config(config), random_params(config)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize(
    "prompt,steps",
    [
        ([], 24),
        ([7, 12], 24),
        ([5, 9, 300, 9, 300], 30),  # repeated bigrams: drafting gets hits
        ([4], 3),  # tiny budget: steps clamp inside a draft window
        ([2, 3, 4, 5, 6, 7, 8], 9),  # budget barely past the prompt
    ],
)
def test_speculative_matches_plain_greedy(model, d, prompt, steps):
    config, params = model
    gen = GenerationConfig(temperature=0.0, steps=steps, seed=0)
    want = Generator(config, params, backend="torch", device="cpu").generate(prompt, gen).tokens
    got = Generator(config, params, backend="torch", device="cpu", speculative=d).generate(prompt, gen)
    assert got.tokens == want, f"d={d} prompt={prompt}: {got.tokens} != {want}"
    assert got.spec_trips <= max(0, steps - len(prompt))


def test_speculative_full_length(model):
    """Full-seq_len generation runs windows into the cache's padded tail."""
    config, params = model
    gen = GenerationConfig(temperature=0.0, steps=0, seed=0)  # 0 = model max
    want = Generator(config, params, backend="torch", device="cpu").generate([9], gen).tokens
    got = Generator(config, params, backend="torch", device="cpu", speculative=4).generate([9], gen).tokens
    assert got == want and len(got) == config.seq_len


def test_speculative_ignored_for_sampling(model):
    """Sampled modes run the plain loop: the same draws, the same tokens."""
    config, params = model
    gen = GenerationConfig(temperature=1.0, top_p=0.9, steps=12, seed=3)
    want = Generator(config, params, backend="torch", device="cpu").generate([7], gen).tokens
    got = Generator(config, params, backend="torch", device="cpu", speculative=4).generate([7], gen)
    assert got.tokens == want and got.spec_trips == 0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_speculative_with_kv_quant(model, backend):
    """Speculation composes with the int8 cache (padded scale arrays); on
    ``cuda`` the verify windows run the int8 window kernel's plain version."""
    config, params = model
    gen = GenerationConfig(temperature=0.0, steps=20, seed=0)
    want = Generator(config, params, backend=backend, device="cpu", kv_quant=True).generate([7, 12], gen)
    got = Generator(config, params, backend=backend, device="cpu", kv_quant=True, speculative=4).generate(
        [7, 12], gen
    )
    assert got.tokens == want.tokens and got.spec_trips > 0


def test_prompt_lookup_drafts():
    """The continuation of the latest earlier occurrence, padded with the token."""
    assert prompt_lookup([5, 9, 300, 9, 300, 9], 9, 4) == [300, 9, 9]
    assert prompt_lookup([5, 9, 300, 7], 9, 4) == [300, 7, 9]
    assert prompt_lookup([5, 6], 7, 3) == [7, 7]
    assert prompt_lookup([9], 9, 3) == [9, 9]  # the last token itself is not a match
    assert prompt_lookup([], 1, 2) == [1]


def test_kv_quant_generator_matches_jax(model):
    """fp32, temperature 0: the port's plain path over the int8 cache against
    the JAX ``xla`` path over its int8 cache, whole-prompt and chunked."""
    config, params = model
    jg = JaxGenerator(tiny_config(), params, kv_quant=True)
    tg = Generator(config, params, backend="torch", device="cpu", kv_quant=True)
    for prompt, steps, chunk in (([], 24, None), ([7, 12], 24, None), ([5, 9, 300, 9, 300, 11, 4], 30, 3)):
        want = jg.generate(prompt, JaxGenerationConfig(temperature=0.0, steps=steps), prefill_chunk=chunk)
        got = tg.generate(prompt, GenerationConfig(temperature=0.0, steps=steps), prefill_chunk=chunk)
        assert got.tokens == want.tokens


def test_kv_quant_tracks_the_fp_cache(model):
    """Argmax generation with the int8 cache tracks the fp32 cache's tokens
    (the cache noise is ~0.4% a row)."""
    config, params = model
    gen = GenerationConfig(temperature=0.0, steps=24, seed=0)
    ref = Generator(config, params, backend="torch", device="cpu").generate([7, 12], gen).tokens
    got = Generator(config, params, backend="torch", device="cpu", kv_quant=True).generate([7, 12], gen).tokens
    agree = sum(a == b for a, b in zip(got, ref)) / max(len(ref), 1)
    assert agree >= 0.75, f"{agree=} {got=} {ref=}"


@pytest.mark.parametrize("extra", [("--kv-cache", "int8"), ("--spec", "4"), ("--kv-cache", "int8", "--spec", "4")])
def test_cli_bytes_match_jax_cli(capsysbinary, tiny_checkpoint, extra):
    """``python -m llama2_tpu_torch`` with the int8 cache and/or speculative
    decoding against the JAX CLI's ``main`` with the same flags."""
    args = (tiny_checkpoint[0], "-t", "0", "-n", "24", "--platform", "cpu", "-z", TOKENIZER_BIN,
            "-i", "Once upon", *extra)
    assert jax_cli.main(list(args)) == 0
    want = capsysbinary.readouterr().out
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    tr = subprocess.run(
        [sys.executable, "-m", "llama2_tpu_torch", *args, "--kernels", "torch", "-v"],
        capture_output=True, timeout=240, env=env, cwd=REPO,
    )
    assert tr.returncode == 0, tr.stderr.decode()
    assert tr.stdout == want and len(want) > 0


def test_cli_spec_warns_when_sampling(tiny_checkpoint):
    """``--spec`` with a temperature warns, as the JAX CLI does, and runs."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    tr = subprocess.run(
        [sys.executable, "-m", "llama2_tpu_torch", tiny_checkpoint[0], "-t", "0.8", "-n", "8", "-s", "1",
         "--platform", "cpu", "-z", TOKENIZER_BIN, "--spec", "4"],
        capture_output=True, timeout=240, env=env, cwd=REPO,
    )
    assert tr.returncode == 0, tr.stderr.decode()
    assert b"warning: --spec applies to greedy decoding only (-t 0); ignored" in tr.stderr
