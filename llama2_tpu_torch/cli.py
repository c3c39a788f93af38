"""CLI mirroring the reference's surface (main.zig:800-934).

Port of ``llama2_tpu/cli.py``: the same flags, defaults, hand-rolled arg loop
(unknown flag -> usage; missing value / unparseable value / duplicate
checkpoint -> error exit 1), output framing and ``{d} tokens per second``
verbose report. Runs on the card unless ``--platform cpu`` asks for the CPU.

``--kv-cache int8`` runs with the int8 KV cache and ``--spec N`` with exact
speculative decoding (greedy only). ``--profile DIR`` traces the timed
``generate`` with ``torch.profiler`` (the CPU, and the card when it runs
there) and writes a Chrome trace into DIR. The prompt is encoded by the C++
tokenizer (``tokenizer/fast/``).

``--seq-shards N`` (N >= 2) decodes through the sequence-sharded decoder
(``parallel/ring_decode.py::SeqShardedDecoder``): N ranks spawned by
``parallel/distributed.py::launch`` over a ``(seq,)`` mesh, each loading the
checkpoint itself and holding ``seq_len / N`` rows of the KV cache (on the
card they share it over gloo; ``--platform cpu`` runs them on the CPU).
Rank 0's tokens come back here and print with the plain path's framing. It
is the fp path, as the JAX CLI's: ``--quant int8``, or a Q8 checkpoint or
param cache, exits 1; ``--spec``, ``--kv-cache`` and ``--kernels`` warn that
they do not apply and are ignored. The port's default ``--kernels`` is
``cuda`` (the JAX CLI's is ``xla``), so that warning fires only where
``--kernels`` was passed.
"""

from __future__ import annotations

import sys

USAGE = """Usage:   python -m llama2_tpu_torch <checkpoint | param-cache dir> [options]
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
 --save-cache <dir>        write the loaded (and quantized) params as a param-cache
                           directory; pass it as the checkpoint path to skip
                           the parse and the quantization next time
 --kv-cache <f32|int8>     KV cache storage: the activation dtype, or int8 rows
                           with a float32 scale a row
 --spec <int>              exact speculative decoding: 2..64 tokens per verify
                           window (prompt-lookup drafts), greedy (-t 0) only
 --warmup                  run a warmup generate before the timed one
 --profile <dir>           write a torch.profiler Chrome trace of the timed
                           generate into dir
 --seq-shards <int>        decode with the KV cache's sequence axis cut over
                           this many ranks (>= 2; fp weights only)
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
        "kernels_given": False,
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
            opts["kernels_given"] = True
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


SEQ_QUANT_REFUSAL = ("--seq-shards runs the fp/XLA sequence-sharded decoder; "
                     "--quant int8 is not supported on this path")
SEQ_DEADLINE_S = 7 * 24 * 3600.0  # the ranks' deadline under --seq-shards: a user's run, not a test's


def main(argv: list[str] | None = None) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    if opts is None:
        return 0
    if opts["seq_shards"] >= 2 and opts["quant"] == "int8":
        # the JAX CLI's refusal, made before the weights are read
        _die(SEQ_QUANT_REFUSAL)

    # import lazily so `-h` costs nothing
    import torch

    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.io import load_any
    from llama2_tpu_torch.runtime.generator import Generator
    from llama2_tpu_torch.tokenizer.fast import load_tokenizer
    from llama2_tpu_torch.tokenizer.tokenizer import BOS

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
    log(f"dtype: {opts['dtype']}  quant: {opts['quant']}  kernels: {opts['kernels']}  "
        f"kv-cache: {opts['kv_cache']}  spec: {opts['spec']}")
    log("")

    tokenizer = load_tokenizer(opts["tokenizer_path"], config.vocab_size)
    prompt_tokens: list[int] = []
    if opts["input"]:
        prompt_tokens = tokenizer.encode(opts["input"])

    if opts["quant"] == "int8":
        from llama2_tpu_torch.quant.q8 import QuantTensor, quantize_params

        if not any(isinstance(v, QuantTensor) for v in params.values()):
            # on the device: the quantizer gives the numpy path's bytes there
            params = quantize_params({k: torch.as_tensor(v).to(device) for k, v in params.items()})
    if opts["save_cache"]:
        from llama2_tpu_torch.io.cache import save_cache

        save_cache(opts["save_cache"], config, params, shared)
        log(f"wrote param cache to {opts['save_cache']}")
    if opts["seq_shards"] >= 2:
        from llama2_tpu_torch.quant.q8 import QuantTensor

        if any(isinstance(v, QuantTensor) for v in params.values()):
            _die(SEQ_QUANT_REFUSAL)
        del params
        return _run_seq_sharded(opts, config, prompt_tokens, tokenizer, device, log)

    generator = Generator(
        config,
        params,
        dtype=torch.float32 if opts["dtype"] == "f32" else torch.bfloat16,
        backend=opts["kernels"],
        device=device,
        kv_quant=opts["kv_cache"] == "int8",
        speculative=opts["spec"],
    )
    del params
    gen = GenerationConfig(
        temperature=opts["temperature"],
        top_p=opts["top_p"],
        steps=opts["seq_len"],
        seed=opts["seed"],
    )
    if opts["spec"] >= 2 and opts["temperature"] != 0.0:
        print(
            "warning: --spec applies to greedy decoding only (-t 0); ignored",
            file=sys.stderr,
        )
    if opts["warmup"]:
        generator.generate(
            [],
            GenerationConfig(
                temperature=opts["temperature"], top_p=opts["top_p"], steps=2, seed=0
            ),
        )
    def run():
        return generator.generate(prompt_tokens, gen, prefill_chunk=opts["prefill_chunk"])

    result = _profiled(opts["profile"], device, log, run) if opts["profile"] else run()

    sys.stdout.buffer.write(tokenizer.decode(result.tokens, first_prev=BOS))
    sys.stdout.buffer.flush()
    log(f"\n\n{int(result.tokens_per_sec)} tokens per second")
    log(f"ttft: {result.ttft_s * 1e3:.1f} ms")
    return 0


def _seq_shard_rank(mesh, path: str, prompt_tokens: list[int], gen) -> tuple[list[int], float]:
    """One rank of ``--seq-shards``: the checkpoint loaded here, the decoder
    over ``mesh``; returns the emitted tokens and the decode's seconds."""
    import time

    from llama2_tpu_torch.io import load_any
    from llama2_tpu_torch.parallel.ring_decode import SeqShardedDecoder

    config, params, _ = load_any(path)
    decoder = SeqShardedDecoder(config, params, mesh)
    del params
    t0 = time.perf_counter()
    tokens = decoder.generate_batch([prompt_tokens], gen)[0]
    return tokens, time.perf_counter() - t0


def _run_seq_sharded(opts, config, prompt_tokens: list[int], tokenizer, device, log) -> int:
    """``--seq-shards N``: the sequence-sharded decoder over N spawned ranks
    (no CUDA kernel on this path: nothing is built), with the Generator
    path's sampling flags and output framing."""
    from llama2_tpu_torch.config import GenerationConfig
    from llama2_tpu_torch.parallel import distributed
    from llama2_tpu_torch.parallel.mesh import SEQ_AXIS
    from llama2_tpu_torch.tokenizer.tokenizer import BOS

    for flag, given in (("--spec", opts["spec"] != 0), ("--kv-cache", opts["kv_cache"] != "f32"),
                        ("--kernels", opts["kernels_given"])):
        if given:
            print(f"warning: {flag} does not apply to --seq-shards (the fp sequence-sharded decoder); ignored",
                  file=sys.stderr)
    n = opts["seq_shards"]
    if config.seq_len % n:
        _die(f"seq_len={config.seq_len} not divisible by sp={n}")
    gen = GenerationConfig(temperature=opts["temperature"], top_p=opts["top_p"], steps=opts["seq_len"],
                           seed=opts["seed"])
    log(f"seq shards: {n} (rows per shard: {config.seq_len // n})")
    ranks = distributed.launch(_seq_shard_rank, n, 1, device.type, opts["bin_path"], prompt_tokens, gen,
                               axis=SEQ_AXIS, libraries=(), deadline=SEQ_DEADLINE_S)
    tokens, total_s = ranks[0]
    sys.stdout.buffer.write(tokenizer.decode(tokens, first_prev=BOS))
    sys.stdout.buffer.flush()
    tps = (len(tokens) - 1) / total_s if len(tokens) > 1 and total_s > 0 else 0.0
    log(f"\n\n{int(tps)} tokens per second")
    return 0


def _profiled(trace_dir: str, device, log, run):
    """``run()`` under ``torch.profiler`` (the CPU's activity, and the card's
    when ``device`` is one); the trace goes to ``trace_dir`` (made if absent)
    as a Chrome trace. Returns what ``run`` returns."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        out = run()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"llama2_tpu_torch.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    log(f"wrote profile trace to {path}")
    return out
