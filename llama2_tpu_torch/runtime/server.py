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
C++ tokenizer (``tokenizer/fast/``). ``--mesh`` and ``--collective-matmul``
are not yet ported and exit 1.
"""

from __future__ import annotations

import json
import sys
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from llama2_tpu_torch.config import GenerationConfig

_UNPORTED = ("--mesh", "--collective-matmul")


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
                out["prefix_hit_pages"] = eng.metrics["prefix_hit_pages"]
                out["prefix_cached_pages"] = len(eng.prefix.key2page)
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


def serve(engine, tokenizer, host: str = "127.0.0.1", port: int = 8000):
    """Start the engine thread and the HTTP server (blocks until interrupted)."""
    _Handler.engine = engine
    _Handler.tokenizer = tokenizer
    engine.start()
    httpd = ThreadingHTTPServer((host, port), _Handler)
    print(f"serving on http://{host}:{httpd.server_port} (slots={engine.batch_size})",
          file=sys.stderr, flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        engine.stop()


def _lengths(value: str) -> list[int]:
    """``--precompile``'s prompt lengths: ``L1,L2,...``."""
    lens = [int(v) for v in value.split(",") if v]
    if any(n < 0 for n in lens):
        raise ValueError(value)
    return lens


def _die(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    opts = {
        "path": None, "tok_path": "tokenizer.bin", "port": 8000, "host": "127.0.0.1", "batch": 8,
        "quant": "none", "dtype": "f32", "platform": "gpu", "paged": False, "page_size": 256,
        "n_pages": None, "prefix_cache": False, "ticks": 1, "pipeline_depth": 2,
        "kv_cache": "f32", "kernels": "cuda", "spec": 0, "precompile": None,
    }
    valued = {
        "-z": ("tok_path", str), "--port": ("port", int), "--host": ("host", str),
        "--batch-size": ("batch", int), "--quant": ("quant", str), "--dtype": ("dtype", str),
        "--platform": ("platform", str), "--ticks-per-sync": ("ticks", int),
        "--pipeline-depth": ("pipeline_depth", int), "--kv-cache": ("kv_cache", str),
        "--kernels": ("kernels", str), "--page-size": ("page_size", int), "--pages": ("n_pages", int),
        "--spec": ("spec", int), "--precompile": ("precompile", _lengths),
    }
    choices = {
        "quant": ("none", "int8"), "dtype": ("f32", "bf16"), "platform": ("cpu", "gpu"),
        "kv_cache": ("f32", "int8"), "kernels": ("cuda", "cuda-accurate", "torch"),
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in _UNPORTED:
            return _die(f"{a} is not yet ported to the torch package")
        if a in valued:
            key, kind = valued[a]
            if i + 1 >= len(argv):
                return _die(f"{a} needs a value")
            i += 1
            try:
                opts[key] = kind(argv[i])
            except ValueError:
                return _die(f"{a}: bad value {argv[i]!r}")
            if key in choices and opts[key] not in choices[key]:
                return _die(f"{a} must be one of {', '.join(choices[key])}")
            if key == "spec" and not (opts["spec"] == 0 or 2 <= opts["spec"] <= 64):
                return _die("--spec must be 0 or 2..64")
        elif a == "--paged":
            opts["paged"] = True
        elif a == "--prefix-cache":
            opts["prefix_cache"] = True
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

    import torch

    if opts["platform"] == "gpu" and not torch.cuda.is_available():
        return _die("no CUDA device available; pass --platform cpu to run on the CPU")
    device = torch.device("cuda" if opts["platform"] == "gpu" else "cpu")

    from llama2_tpu_torch.io import load_any
    from llama2_tpu_torch.runtime.batch_engine import BatchEngine, start_kernel_builds
    from llama2_tpu_torch.tokenizer.fast import load_tokenizer

    config, params, _ = load_any(opts["path"])
    tokenizer = load_tokenizer(opts["tok_path"], config.vocab_size)
    if opts["quant"] == "int8":
        from llama2_tpu_torch.quant.q8 import QuantTensor, quantize_params

        if not any(isinstance(v, QuantTensor) for v in params.values()):
            # on the device: the quantizer gives the numpy path's bytes there
            params = quantize_params({k: torch.as_tensor(v).to(device) for k, v in params.items()})
    kw = dict(
        batch_size=opts["batch"],
        dtype=torch.float32 if opts["dtype"] == "f32" else torch.bfloat16,
        backend=opts["kernels"],
        device=device,
        ticks_per_sync=opts["ticks"],
        pipeline_depth=opts["pipeline_depth"],
        kv_quant=opts["kv_cache"] == "int8",
        spec_window=opts["spec"],
    )
    if opts["paged"]:
        from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine

        engine = PagedBatchEngine(config, params, page_size=opts["page_size"], n_pages=opts["n_pages"],
                                  prefix_cache=opts["prefix_cache"], **kw)
    else:
        t0 = time.perf_counter()
        if opts["precompile"] is not None and device.type == "cuda":
            # the builds run while the weights upload
            start_kernel_builds(params, opts["kernels"], kw["kv_quant"])
        engine = BatchEngine(config, params, **kw)
        if opts["precompile"] is not None:
            n = engine.precompile(prompt_lens=opts["precompile"], stochastic=(False, True), spec=opts["spec"] > 0)
            print(f"precompiled {n} programs in {time.perf_counter() - t0:.1f}s (builds overlapped with the "
                  "weight upload)", file=sys.stderr, flush=True)
    del params
    serve(engine, tokenizer, opts["host"], opts["port"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
