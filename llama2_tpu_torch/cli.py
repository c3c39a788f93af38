"""CLI mirroring the reference's surface (main.zig:800-934).

Port of ``llama2_tpu/cli.py``: the same flags, defaults, hand-rolled arg loop
(unknown flag -> usage; missing value / unparseable value / duplicate
checkpoint -> error exit 1), output framing and ``{d} tokens per second``
verbose report. Runs on the card unless ``--platform cpu`` asks for the CPU.

Flags whose path is not ported to the torch package yet (``--kv-cache int8``,
``--spec N``, ``--seq-shards N``, ``--save-cache``, ``--profile``) exit 1
with a message rather than being ignored.
"""

from __future__ import annotations

import sys

USAGE = """Usage:   python -m llama2_tpu_torch <checkpoint> [options]
Example: python -m llama2_tpu_torch checkpoint.bin -n 256 -i "Once upon a time"
Options:
 -h, --help                print this help message
 -t, --temperature <float> temperature, default 1.0 (0.0, 1]
 -p, --top-p <float>       p value in top-p (nucleus) sampling. default 0.9, 0 || 1 = off
 -n, --seq-len <int>       number of steps to run for, default 256. 0 = max_seq_len
 -i, --input <string>      input text for the prompt, default ""
 -s, --seed <int>          random seed, default to time
 -v, --verbose             print model info and tokens/s
 -z, --tokenizer <path>    path to the tokenizer to use, default to "tokenizer.bin"
GPU options:
 --dtype <f32|bf16>        compute/weight dtype, default f32 (f32 = parity mode)
 --quant <none|int8>       weight-only INT8 (group-quantized Q8_0); an ak42
                           checkpoint is used as it is, an fp one is quantized
 --prefill-chunk <int>     prefill segment length, default whole prompt
 --platform <cpu|gpu>      device to run on, default gpu
 --kernels <torch|cuda|cuda-accurate>
                           hand-written CUDA kernels (default; fast-mode INT8
                           matmul), the same with the accurate-mode INT8
                           matmul, or the plain PyTorch versions
 --warmup                  run a warmup generate before the timed one
Not yet ported to the torch package (exit 1 when set):
 --kv-cache int8, --spec <int>, --seq-shards <int>, --save-cache <dir>,
 --profile <dir>
"""


def _die(msg: str) -> "NoReturn":
    print(f"error: {msg}", file=sys.stderr)
    raise SystemExit(1)


def parse_args(argv: list[str]) -> dict | None:
    """Parse the reference's argv surface; returns None if usage was printed."""
    if len(argv) < 1:
        sys.stdout.write(USAGE)
        return None

    opts = {
        "bin_path": None,
        "input": None,
        "temperature": 1.0,
        "top_p": 0.9,
        "seq_len": 0,
        "tokenizer_path": "tokenizer.bin",
        "seed": None,
        "verbose": False,
        "dtype": "f32",
        "quant": "none",
        "kv_cache": "f32",
        "spec": 0,
        "prefill_chunk": None,
        "profile": None,
        "platform": "gpu",
        "kernels": "cuda",
        "save_cache": None,
        "warmup": False,
        "seq_shards": 0,
    }

    def take_value(i: int, name: str) -> tuple[str, int]:
        if i + 1 >= len(argv):
            _die(f"missing argument for {name}")
        return argv[i + 1], i + 1

    def take_int(i: int, name: str) -> tuple[int, int]:
        val, i = take_value(i, name)
        try:
            return int(val), i
        except ValueError:
            _die(f"unable to parse --{name} argument '{val}'")

    def take_choice(i: int, name: str, choices: tuple[str, ...]) -> tuple[str, int]:
        val, i = take_value(i, name)
        if val not in choices:
            _die(f"unable to parse --{name} argument '{val}'")
        return val, i

    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in ("-h", "--help"):
            sys.stdout.write(USAGE)
            return None
        if not arg.startswith("-"):
            if opts["bin_path"] is not None:
                _die("multiple checkpoint paths specified")
            opts["bin_path"] = arg
        elif arg in ("-t", "--temperature"):
            val, i = take_value(i, "temperature")
            try:
                opts["temperature"] = float(val)
            except ValueError:
                _die(f"unable to parse --temperature argument '{val}'")
        elif arg in ("-p", "--top-p"):
            val, i = take_value(i, "top-p")
            try:
                opts["top_p"] = min(max(float(val), 0.0), 1.0)
            except ValueError:
                _die(f"unable to parse --top-p argument '{val}'")
        elif arg in ("-n", "--seq-len"):
            opts["seq_len"], i = take_int(i, "seq-len")
        elif arg in ("-i", "--input"):
            opts["input"], i = take_value(i, "input")
        elif arg in ("-s", "--seed"):
            opts["seed"], i = take_int(i, "seed")
        elif arg in ("-z", "--tokenizer"):
            opts["tokenizer_path"], i = take_value(i, "tokenizer")
        elif arg in ("-v", "--verbose"):
            opts["verbose"] = True
        elif arg == "--dtype":
            opts["dtype"], i = take_choice(i, "dtype", ("f32", "bf16"))
        elif arg == "--spec":
            opts["spec"], i = take_int(i, "spec")
            if opts["spec"] < 0 or opts["spec"] == 1 or opts["spec"] > 64:
                _die("--spec must be 0 (off) or 2..64 (draft window)")
        elif arg == "--kv-cache":
            opts["kv_cache"], i = take_choice(i, "kv-cache", ("f32", "int8"))
        elif arg == "--quant":
            opts["quant"], i = take_choice(i, "quant", ("none", "int8"))
        elif arg == "--prefill-chunk":
            opts["prefill_chunk"], i = take_int(i, "prefill-chunk")
            if opts["prefill_chunk"] < 1:
                _die("--prefill-chunk must be >= 1")
        elif arg == "--profile":
            opts["profile"], i = take_value(i, "profile")
        elif arg == "--platform":
            opts["platform"], i = take_choice(i, "platform", ("cpu", "gpu"))
        elif arg == "--kernels":
            opts["kernels"], i = take_choice(i, "kernels", ("torch", "cuda", "cuda-accurate"))
        elif arg == "--save-cache":
            opts["save_cache"], i = take_value(i, "save-cache")
        elif arg == "--seq-shards":
            opts["seq_shards"], i = take_int(i, "seq-shards")
            if opts["seq_shards"] < 0:
                _die("--seq-shards must be >= 0")
        elif arg == "--warmup":
            opts["warmup"] = True
        else:
            print(f"error: unknown argument '{arg}'", file=sys.stderr)
            sys.stdout.write(USAGE)
            return None
        i += 1
    if opts["bin_path"] is None:
        sys.stdout.write(USAGE)
        return None
    return opts


def _refuse_unported(opts: dict) -> None:
    """Exit 1 for a flag whose path the torch package does not have yet."""
    for flag, key, off in (
        ("--kv-cache int8", "kv_cache", "f32"),
        ("--spec", "spec", 0),
        ("--save-cache", "save_cache", None),
        ("--profile", "profile", None),
    ):
        if opts[key] != off:
            _die(f"{flag} is not yet ported to the torch package")
    if opts["seq_shards"] >= 2:
        _die("--seq-shards is not yet ported to the torch package")


def main(argv: list[str] | None = None) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    if opts is None:
        return 0
    _refuse_unported(opts)

    # import lazily so `-h` costs nothing
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io import load_any
    from llama2_tpu_torch.runtime.generator import Generator
    from llama2_tpu_torch.tokenizer.tokenizer import BOS, Tokenizer

    if opts["platform"] == "gpu" and not torch.cuda.is_available():
        _die("no CUDA device available; pass --platform cpu to run on the CPU")
    device = torch.device("cuda" if opts["platform"] == "gpu" else "cpu")

    def log(msg: str):
        if opts["verbose"]:
            print(msg, file=sys.stderr)

    config, params, shared = load_any(opts["bin_path"])
    log(f"config: {config}")
    log(f"shared weights: {shared}")
    log(f"temperature: {opts['temperature']}")
    log(f"top-p: {opts['top_p']}")
    log(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    log(f"dtype: {opts['dtype']}  quant: {opts['quant']}  kernels: {opts['kernels']}")
    log("")

    tokenizer = Tokenizer.from_file(opts["tokenizer_path"], config.vocab_size)
    prompt_tokens: list[int] = []
    if opts["input"]:
        prompt_tokens = tokenizer.encode(opts["input"])

    if opts["quant"] == "int8":
        from llama2_tpu_torch.quant.q8 import QuantTensor, quantize_params

        if not any(isinstance(v, QuantTensor) for v in params.values()):
            params = quantize_params(params)

    generator = Generator(
        config,
        params,
        dtype=torch.float32 if opts["dtype"] == "f32" else torch.bfloat16,
        backend=opts["kernels"],
        device=device,
    )
    del params
    gen = GenerationConfig(
        temperature=opts["temperature"],
        top_p=opts["top_p"],
        steps=opts["seq_len"],
        seed=opts["seed"],
    )
    if opts["warmup"]:
        generator.generate(
            [],
            GenerationConfig(
                temperature=opts["temperature"], top_p=opts["top_p"], steps=2, seed=0
            ),
        )
    result = generator.generate(prompt_tokens, gen, prefill_chunk=opts["prefill_chunk"])

    sys.stdout.buffer.write(tokenizer.decode(result.tokens, first_prev=BOS))
    sys.stdout.buffer.flush()
    log(f"\n\n{int(result.tokens_per_sec)} tokens per second")
    log(f"ttft: {result.ttft_s * 1e3:.1f} ms")
    return 0
