"""The torch port's INT8 (Q8) Generator and CLI against the JAX package.

* ``Generator(device="cpu")`` on quantized params is token-identical to the
  JAX ``Generator`` at temperature 0 for ``torch`` <-> ``xla`` and for
  ``cuda-accurate`` <-> ``pallas-accurate``. At this narrow head size the JAX
  ``Generator`` lane-pads its cache, so its kernel path is K6 + rope + the
  stacked decode kernel: the same arithmetic as ``cuda-accurate``.
* ``backend="cuda"`` (fast mode) gives the port's own fast-mode tokens, which
  must equal the ``forward``-level greedy stream, and fuses the QKV params
  (W1/W3 stay separate for the FFN megakernel).
* ``python -m llama2_tpu_torch ... --quant int8 --platform cpu`` and the same
  on an ak42 file print the same bytes as the JAX CLI.
"""

import os
import subprocess
import sys

import pytest
import torch

from conftest import TOKENIZER_BIN, random_params
from llama2_tpu import cli as jax_cli
from llama2_tpu.config import GenerationConfig as JaxGenerationConfig
from llama2_tpu.config import ModelConfig
from llama2_tpu.quant import q8 as jq
from llama2_tpu.runtime.generator import Generator as JaxGenerator
from llama2_tpu_torch.config import GenerationConfig
from llama2_tpu_torch.config import ModelConfig as TorchModelConfig
from llama2_tpu_torch.quant import convert
from llama2_tpu_torch.quant import q8 as tq
from llama2_tpu_torch.runtime.generator import Generator


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread here: beside the JAX runtime's threads, and the
    other test workers', more threads only slow these small shapes down."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw) -> ModelConfig:
    base = dict(dim=64, hidden_dim=172, n_layers=3, n_heads=4, n_kv_heads=2,
                vocab_size=512, seq_len=96)
    base.update(kw)
    return ModelConfig(**base)


def port_config(c: ModelConfig) -> TorchModelConfig:
    return TorchModelConfig(**{f: getattr(c, f) for f in (
        "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size",
        "seq_len", "norm_eps")})


PAIRS = [("torch", "xla"), ("cuda-accurate", "pallas-accurate")]
# (prompt, steps, prefill_chunk): whole-prompt and chunked prefill, the empty
# prompt, and a chunk of 1 (token-at-a-time)
CASES = [([], 40, None), ([5, 17, 320, 9], 40, None), ([5, 17, 320, 9, 44, 2, 100], 36, 3),
         ([5, 17, 320, 9], 24, 1)]


@pytest.fixture(scope="module")
def generators():
    config = _cfg()
    params = random_params(config, seed=11)
    jp, tp = jq.quantize_params(params, 16), tq.quantize_params(params, 16)
    out = {}
    for backend, jax_backend in PAIRS:
        out[backend] = (
            JaxGenerator(config, jp, backend=jax_backend),
            Generator(port_config(config), tp, backend=backend, device="cpu"),
        )
    return out


@pytest.mark.parametrize("backend", [p[0] for p in PAIRS])
@pytest.mark.parametrize("prompt,steps,chunk", CASES)
def test_q8_generate_token_identical_to_jax(generators, backend, prompt, steps, chunk):
    jg, tg = generators[backend]
    want = jg.generate(prompt, JaxGenerationConfig(temperature=0.0, steps=steps), prefill_chunk=chunk)
    got = tg.generate(prompt, GenerationConfig(temperature=0.0, steps=steps), prefill_chunk=chunk)
    assert got.tokens == want.tokens
    assert len(got.tokens) > len(prompt)  # it generated something


def test_q8_generator_fuses_for_the_kernel_backends_only():
    config = _cfg()
    tp = tq.quantize_params(random_params(config, seed=11), 16)
    pcfg = port_config(config)
    fast = Generator(pcfg, tp, backend="cuda", device="cpu")
    plain = Generator(pcfg, tp, backend="torch", device="cpu", dtype=torch.bfloat16)
    assert "wqkv" in fast.params and "wq" not in fast.params
    # w1/w3 stay separate for the FFN megakernel: the caller's tensors, no copy
    assert "w13" not in fast.params and fast.params["w1"].q is tp["w1"].q
    assert "wq" in plain.params and "wqkv" not in plain.params
    # INT8 values and float32 scales survive the dtype; norms and embedding take it
    assert plain.params["wq"].q.dtype == torch.int8 and plain.params["wq"].scale.dtype == torch.float32
    assert plain.params["rms_att"].dtype == plain.params["tok_emb"].dtype == torch.bfloat16
    gen = GenerationConfig(temperature=0.0, steps=30)
    a = fast.generate([5, 17, 320, 9], gen).tokens
    assert a == fast.generate([5, 17, 320, 9], gen).tokens  # repeats from run to run
    assert a[:4] == [5, 17, 320, 9] and len(a) > 4
    b = plain.generate([5, 17, 320, 9], gen).tokens
    assert b[:4] == [5, 17, 320, 9] and len(b) > 4


# ---- CLI ----


def jax_cli_bytes(capsysbinary, *args) -> bytes:
    """The JAX CLI's ``main`` in process (JAX is imported and pinned to the
    CPU here): what ``python -m llama2_tpu`` prints."""
    assert jax_cli.main(list(args)) == 0
    return capsysbinary.readouterr().out


def port_cli(*args) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run(
        [sys.executable, "-m", "llama2_tpu_torch", *args, "-v"],
        capture_output=True, timeout=240, env=env, cwd=REPO,
    )


def test_cli_quant_int8_bytes_match_jax_cli(capsysbinary, tiny_checkpoint):
    """``--quant int8`` on an fp checkpoint: quantized on load in both CLIs,
    dequantize-beside-the-dot on both sides."""
    args = (tiny_checkpoint[0], "-t", "0", "-n", "24", "--platform", "cpu", "-z", TOKENIZER_BIN,
            "--quant", "int8")
    want = jax_cli_bytes(capsysbinary, *args, "--kernels", "xla")
    tr = port_cli(*args, "--kernels", "torch")
    assert tr.returncode == 0, tr.stderr.decode()
    assert tr.stdout == want and len(want) > 0
    assert b"quant: int8" in tr.stderr and b"tokens per second" in tr.stderr


def test_cli_ak42_file_bytes_match_jax_cli(capsysbinary, tiny_checkpoint, tmp_path):
    """An ak42 file written by the port's converter, through the accurate
    kernel path of both CLIs, with and without ``--quant int8`` (an already
    quantized checkpoint is used as it is)."""
    q8 = str(tmp_path / "model-q8.bin")
    assert convert.main([tiny_checkpoint[0], q8, "--group-size", "32"]) == 0
    args = (q8, "-t", "0", "-n", "24", "--platform", "cpu", "-z", TOKENIZER_BIN, "-i", "Once upon")
    want = jax_cli_bytes(capsysbinary, *args, "--kernels", "pallas-accurate")
    tr = port_cli(*args, "--kernels", "cuda-accurate", "--quant", "int8")
    assert tr.returncode == 0, tr.stderr.decode()
    assert tr.stdout == want and len(want) > 0
