"""HTTP serving front end over the continuous-batching engines.

A copy of ``llama2_tpu/runtime/server.py`` over the port's engines
(stdlib ``ThreadingHTTPServer``; the reference is a one-shot CLI).

Endpoints:
  POST /generate  {"prompt": str, "temperature": f, "top_p": f, "steps": n,
                   "seed": n}  ->  {"text", "tokens", "prompt_len",
                   "ttft_ms", "total_ms", "tokens_per_sec"}
  GET  /health    -> {"status": "ok", "slots": N, "active": A, "waiting": M}
  GET  /metrics   -> request/token counters, TTFT percentiles (and the
                     prefix cache's pages with --prefix-cache)

Run:  python -m llama2_tpu_torch.runtime.server <checkpoint> \\
          [-z tokenizer.bin] [--host H] [--port 8000] [--batch-size 8]
          [--quant int8] [--dtype f32|bf16] [--platform cpu|gpu]
          [--paged [--page-size 256] [--pages N] [--prefix-cache]]
          [--ticks-per-sync K] [--pipeline-depth P] [--kv-cache f32|int8]
          [--kernels cuda|cuda-accurate|torch] [--spec N] [--precompile L1,L2,...]
          [--mesh DPxTP [--collective-matmul]]

``--paged`` switches the KV cache to page pools (runtime/paged_engine.py):
memory scales with the tokens in flight instead of batch_size * seq_len.
``--prefix-cache`` shares the full pages of prompt prefixes across requests,
so a repeated system prompt prefills only its suffix. ``--port 0`` takes a
free port (the address is printed). ``--spec N`` (0, or 2 to 64) runs
greedy speculative windows of N tokens whenever every active request is
greedy (``ticks_per_sync`` then counts windows). ``--precompile L1,L2,...``
(the dense engine only; exit 1 with ``--paged``) pays the cold start before
the server answers: the kernel builds start before the weight upload, then
``BatchEngine.precompile`` builds and warms the prefill chunks of those prompt
lengths, the decode tick (greedy and sampled) and, with ``--spec``, the
window. The engines run on the card (``--platform gpu``, the default; exit 1
without one) unless ``--platform cpu`` is given; prompts are encoded by the
C++ tokenizer (``tokenizer/fast/``).

``--mesh DPxTP`` serves the engine (dense, or with ``--paged`` the paged
one, ``parallel/dp_paged.py``: pages on ``data`` with an allocator and a
prefix cache a data group, kv heads on ``model``) over a ``(data, model)`` mesh of
``DP * TP`` ranks, one process each (``parallel/``): this process is rank 0
and serves HTTP; it spawns the others, which load their shards and follow
its lockstep: a param-cache directory is memory-mapped and each rank reads
only its slices (as ``io/cache.py::load_cache_sharded``); a checkpoint file
is read whole, once a rank, and each keeps its slices. ``--quant int8``
under ``--mesh`` takes weights quantized ahead (a Q8 param cache or an ak42
file; else exit 1: write one with ``--save-cache``). The
collective backend is NCCL where every rank owns a card, else gloo (printed).
Ctrl-C stops every rank and the server exits 0; a rank that dies ends the
server with exit 1. ``--collective-matmul`` makes the row-parallel reduces
the overlapped ring collective matmul's (``collective="ring"``,
``parallel/collective_matmul.py``); it needs ``--mesh`` (else exit 1), as
in the JAX server. ``--precompile`` with ``--mesh`` exits 1.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from llama2_tpu_torch.config import GenerationConfig

FOLLOWER_JOIN_S = 60.0  # how long a stopped server waits for its followers


class _Handler(BaseHTTPRequestHandler):
    engine = None  # set by serve()
    tokenizer = None

    def _send(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def do_GET(self):
        eng = self.engine
        if self.path == "/health":
            self._send(200, {
                "status": "ok",
                "slots": eng.batch_size,
                "active": sum(1 for s in eng.slots if s is not None),
                "waiting": eng.waiting.qsize(),
            })
        elif self.path == "/metrics":
            pct = eng.ttft_percentiles()

            def ms(v):
                return None if v is None else v * 1e3

            out = {
                "requests": eng.metrics["requests"],
                "tokens": eng.metrics["tokens"],
                "ttft_p50_ms": ms(pct["p50"]),
                "ttft_p95_ms": ms(pct["p95"]),
                # TTFT = queue wait + prefill; under a request wave the p50 is
                # queueing, so both series are reported apart
                "queue_wait_p50_ms": ms(pct["queue_wait_p50"]),
                "prefill_p50_ms": ms(pct["prefill_p50"]),
            }
            if getattr(eng, "prefix", None) is not None:
                # one prefix cache a data group under the paged mesh path
                caches = eng.prefix if isinstance(eng.prefix, list) else [eng.prefix]
                out["prefix_hit_pages"] = eng.metrics["prefix_hit_pages"]
                out["prefix_cached_pages"] = sum(len(c.key2page) for c in caches)
            self._send(200, out)
        else:
            self._send(404, {"error": "not found"})

    def do_POST(self):
        if self.path != "/generate":
            self._send(404, {"error": "not found"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._send(400, {"error": "invalid JSON body"})
            return
        if not isinstance(req, dict):
            self._send(400, {"error": "body must be a JSON object"})
            return

        prompt = req.get("prompt", "")
        if not isinstance(prompt, str):
            self._send(400, {"error": "prompt must be a string"})
            return
        try:
            seed = req.get("seed")
            if seed is not None:
                seed = int(seed)  # a bad seed must fail HERE, not on the
                # engine thread, where one request's error fails the batch
            gen = GenerationConfig(
                temperature=float(req.get("temperature", 1.0)),
                top_p=min(max(float(req.get("top_p", 0.9)), 0.0), 1.0),
                steps=int(req.get("steps", 0)),
                seed=seed,
            )
        except (TypeError, ValueError) as e:
            self._send(400, {"error": f"bad parameter: {e}"})
            return

        try:
            prompt_tokens = self.tokenizer.encode(prompt) if prompt else []
        except ValueError as e:
            self._send(400, {"error": str(e)})
            return

        try:
            res = self.engine.generate(prompt_tokens, gen, timeout=600)
        except Exception as e:  # noqa: BLE001 -- engine errors become 500s
            self._send(500, {"error": str(e)})
            return

        text = self.tokenizer.decode(res.tokens).decode("utf-8", errors="replace")
        decode_s = max(res.total_s - res.ttft_s, 1e-9)
        self._send(200, {
            "text": text,
            "tokens": res.tokens,
            "prompt_len": res.prompt_len,
            "ttft_ms": res.ttft_s * 1e3,
            "total_ms": res.total_s * 1e3,
            "tokens_per_sec": max(len(res.tokens) - 1, 0) / decode_s,
        })


def _watch(engine, followers, httpd, down: list) -> None:
    """Stop serving when the engine's loop fails or a follower rank dies."""
    while not down:
        dead = [p for p in followers if p.exitcode is not None]
        if engine.failed is not None or dead:
            why = engine.failed if engine.failed is not None else f"rank exited with {dead[0].exitcode}"
            print(f"[mesh] stopping: {why}", file=sys.stderr, flush=True)
            down.append(why)
            httpd.shutdown()
            return
        time.sleep(0.2)


def serve(engine, tokenizer, host: str = "127.0.0.1", port: int = 8000, followers=()) -> bool:
    """Start the engine thread and the HTTP server (blocks until interrupted,
    or under a mesh until the engine fails or a follower rank dies). Returns
    whether it stopped cleanly."""
    _Handler.engine = engine
    _Handler.tokenizer = tokenizer
    engine.start()
    httpd = ThreadingHTTPServer((host, port), _Handler)
    print(f"serving on http://{host}:{httpd.server_port} (slots={engine.batch_size})",
          file=sys.stderr, flush=True)
    down: list = []
    if engine.mesh is not None:
        threading.Thread(target=_watch, args=(engine, followers, httpd, down), daemon=True).start()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        clean = not down
        down.append("stopped")
        httpd.server_close()
        engine.stop()
    return clean and engine.failed is None


def _lengths(value: str) -> list[int]:
    """``--precompile``'s prompt lengths: ``L1,L2,...``."""
    lens = [int(v) for v in value.split(",") if v]
    if any(n < 0 for n in lens):
        raise ValueError(value)
    return lens


def _die(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 1


def _mesh_shape(value: str) -> tuple[int, int]:
    """``--mesh``'s ``DPxTP``."""
    dp, tp = (int(v) for v in value.lower().split("x"))
    if dp < 1 or tp < 1:
        raise ValueError(value)
    return dp, tp


def _engine_kw(opts: dict, device) -> dict:
    import torch

    return dict(
        batch_size=opts["batch"],
        dtype=torch.float32 if opts["dtype"] == "f32" else torch.bfloat16,
        backend=opts["kernels"],
        device=device,
        ticks_per_sync=opts["ticks"],
        pipeline_depth=opts["pipeline_depth"],
        kv_quant=opts["kv_cache"] == "int8",
        spec_window=opts["spec"],
    )


def _engine(opts: dict, config, params, device, mesh=None):
    """The engine ``opts`` ask for: paged with ``--paged``, over ``mesh``
    with its collective."""
    kw = _engine_kw(opts, device)
    if mesh is not None:
        kw.update(mesh=mesh, collective=opts["collective"])
    if opts["paged"]:
        from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

        return PagedBatchEngine(config, params, page_size=opts["page_size"], n_pages=opts["n_pages"],
                                prefix_cache=opts["prefix_cache"], **kw)
    from llama2_tpu_torch.runtime.batch_engine import BatchEngine

    return BatchEngine(config, params, **kw)


def _load(opts: dict, device, mesh=None):
    """``(config, params)``: the checkpoint, quantized on ``device`` with
    ``--quant int8``. Under a mesh the whole tree as it loads (a param cache
    memory-mapped, nothing read yet): the engine copies out only this rank's
    slices; ``main`` has refused ``--quant int8`` of unquantized weights."""
    import torch

    from llama2_tpu_torch.io import load_any
    from llama2_tpu_torch.quant.q8 import QuantTensor, quantize_params

    config, params, _ = load_any(opts["path"])
    if mesh is None and opts["quant"] == "int8" and not any(isinstance(v, QuantTensor) for v in params.values()):
        # on the device: the quantizer gives the numpy path's bytes there
        params = quantize_params({k: torch.as_tensor(v).to(device) for k, v in params.items()})
    return config, params


def _follower(opts: dict, rank: int, dp: int, tp: int, init_method: str, backend: str, device_type: str) -> None:
    """A follower rank of ``--mesh``: join the group, load this rank's
    shards, and step in lockstep with rank 0 until it stops."""
    import torch

    from llama2_tpu_torch.parallel import distributed
    from llama2_tpu_torch.parallel.mesh import make_mesh

    signal.signal(signal.SIGINT, signal.SIG_IGN)  # rank 0's stop ends this rank
    if device_type == "cpu":
        torch.set_num_threads(1)  # one thread a rank: the ranks share the host's cores
    distributed.initialize(init_method, dp * tp, rank, device_type, backend)
    try:
        mesh = make_mesh(dp, tp, device_type)
        config, params = _load(opts, mesh.device, mesh)
        engine = _engine(opts, config, params, mesh.device, mesh)
        del params
        engine.follow()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _serve_mesh(opts: dict, dp: int, tp: int, device_type: str) -> int:
    """``--mesh``: spawn the follower ranks, join the group as rank 0, serve."""
    import torch

    from llama2_tpu_torch.parallel import distributed
    from llama2_tpu_torch.parallel.mesh import make_mesh
    from llama2_tpu_torch.tokenizer.fast import load_tokenizer

    world = dp * tp
    followers, tmp = [], None
    if world > 1:
        backend, why = distributed.backend_rule(world, device_type)
        print(why, file=sys.stderr, flush=True)
        if device_type == "cuda" and opts["kernels"].startswith("cuda"):
            from llama2_tpu_torch.ops.cuda import build

            build.build_all(list(distributed.ENGINE_LIBRARIES))  # once, before the ranks load them
        tmp = tempfile.mkdtemp(prefix="llama2-mesh-")
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        ctx = distributed.spawn_context()
        followers = [
            ctx.Process(target=_follower, args=(opts, r, dp, tp, init_method, backend, device_type))
            for r in range(1, world)
        ]
        for p in followers:
            p.start()
        if device_type == "cpu":
            torch.set_num_threads(1)  # one thread a rank: the ranks share the host's cores
        distributed.initialize(init_method, world, 0, device_type, backend)
    clean, engine = False, None
    try:
        mesh = make_mesh(dp, tp, device_type)
        config, params = _load(opts, mesh.device, mesh)
        tokenizer = load_tokenizer(opts["tok_path"], config.vocab_size)
        engine = _engine(opts, config, params, mesh.device, mesh)
        del params
        clean = serve(engine, tokenizer, opts["host"], opts["port"], followers)
    finally:
        end = time.monotonic() + FOLLOWER_JOIN_S
        for p in followers:
            p.join(timeout=max(0.1, end - time.monotonic()))
        stuck = [p for p in followers if p.is_alive()]
        for p in stuck:
            p.kill()
            p.join(timeout=10)
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
        looping = engine is not None and engine._thread is not None and engine._thread.is_alive()
        if stuck or looping:
            # a rank stuck in a collective: tearing the group down could wait on it
            print(f"[mesh] {len(stuck)} follower(s) killed, engine loop {'stuck' if looping else 'ended'}",
                  file=sys.stderr, flush=True)
            os._exit(1)
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    clean = clean and all(p.exitcode == 0 for p in followers)
    return 0 if clean else 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    opts = {
        "path": None, "tok_path": "tokenizer.bin", "port": 8000, "host": "127.0.0.1", "batch": 8,
        "quant": "none", "dtype": "f32", "platform": "gpu", "paged": False, "page_size": 256,
        "n_pages": None, "prefix_cache": False, "ticks": 1, "pipeline_depth": 2,
        "kv_cache": "f32", "kernels": "cuda", "spec": 0, "precompile": None, "mesh": None, "collective": None,
    }
    valued = {
        "-z": ("tok_path", str), "--port": ("port", int), "--host": ("host", str),
        "--batch-size": ("batch", int), "--quant": ("quant", str), "--dtype": ("dtype", str),
        "--platform": ("platform", str), "--ticks-per-sync": ("ticks", int),
        "--pipeline-depth": ("pipeline_depth", int), "--kv-cache": ("kv_cache", str),
        "--kernels": ("kernels", str), "--page-size": ("page_size", int), "--pages": ("n_pages", int),
        "--spec": ("spec", int), "--precompile": ("precompile", _lengths), "--mesh": ("mesh", _mesh_shape),
    }
    choices = {
        "quant": ("none", "int8"), "dtype": ("f32", "bf16"), "platform": ("cpu", "gpu"),
        "kv_cache": ("f32", "int8"), "kernels": ("cuda", "cuda-accurate", "torch"),
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in valued:
            key, kind = valued[a]
            if i + 1 >= len(argv):
                return _die(f"{a} needs a value")
            i += 1
            try:
                opts[key] = kind(argv[i])
            except ValueError:
                if a == "--mesh":
                    return _die("--mesh must look like 2x4 (data x model)")
                return _die(f"{a}: bad value {argv[i]!r}")
            if key in choices and opts[key] not in choices[key]:
                return _die(f"{a} must be one of {', '.join(choices[key])}")
            if key == "spec" and not (opts["spec"] == 0 or 2 <= opts["spec"] <= 64):
                return _die("--spec must be 0 or 2..64")
        elif a == "--paged":
            opts["paged"] = True
        elif a == "--prefix-cache":
            opts["prefix_cache"] = True
        elif a == "--collective-matmul":
            opts["collective"] = "ring"
        elif not a.startswith("-") and opts["path"] is None:
            opts["path"] = a
        else:
            return _die(f"unknown argument {a}")
        i += 1
    if opts["path"] is None:
        return _die(__doc__)
    if opts["prefix_cache"] and not opts["paged"]:
        return _die("--prefix-cache requires --paged")
    if opts["precompile"] is not None and opts["paged"]:
        return _die("--precompile covers the dense engine (not --paged)")
    if opts["collective"] and opts["mesh"] is None:
        return _die("--collective-matmul requires --mesh")
    if opts["precompile"] is not None and opts["mesh"] is not None:
        return _die("--precompile covers the dense single-device engine (not --mesh)")
    if opts["mesh"] is not None and opts["quant"] == "int8":
        from llama2_tpu_torch.io import is_quantized

        if not is_quantized(opts["path"]):
            # quantizing here would put the whole model on the device once a rank
            return _die(
                "--mesh with --quant int8 serves weights quantized ahead, of which each rank keeps its "
                "slices: write a Q8 param cache first (python -m llama2_tpu_torch <checkpoint> --quant int8 "
                "--save-cache DIR -n 1) and serve DIR"
            )

    import torch

    if opts["platform"] == "gpu" and not torch.cuda.is_available():
        return _die("no CUDA device available; pass --platform cpu to run on the CPU")
    device = torch.device("cuda" if opts["platform"] == "gpu" else "cpu")
    if opts["mesh"] is not None:
        return _serve_mesh(opts, *opts["mesh"], device.type)

    from llama2_tpu_torch.runtime.batch_engine import start_kernel_builds
    from llama2_tpu_torch.tokenizer.fast import load_tokenizer

    config, params = _load(opts, device)
    tokenizer = load_tokenizer(opts["tok_path"], config.vocab_size)
    t0 = time.perf_counter()
    if opts["precompile"] is not None and device.type == "cuda":
        # the builds run while the weights upload
        start_kernel_builds(params, opts["kernels"], opts["kv_cache"] == "int8")
    engine = _engine(opts, config, params, device)
    if opts["precompile"] is not None:
        n = engine.precompile(prompt_lens=opts["precompile"], stochastic=(False, True), spec=opts["spec"] > 0)
        print(f"precompiled {n} programs in {time.perf_counter() - t0:.1f}s (builds overlapped with the "
              "weight upload)", file=sys.stderr, flush=True)
    del params
    serve(engine, tokenizer, opts["host"], opts["port"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
