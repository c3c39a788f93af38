"""The torch port's HTTP server over the port's engines (in-process, CPU).

The contracts of ``tests/test_server.py`` that involve no mesh: health, generate, determinism, concurrent requests, bad JSON,
bad parameters, an unknown codepoint (400), metrics (with the prefix cache's
counters on a paged engine), 404; greedy text equal to the port
``Generator``'s. The entry point itself (``python -m
llama2_tpu_torch.runtime.server ... --platform cpu --port 0``) serves a
request in a subprocess, also with ``--spec 4``; unported flags, bad values
(``--spec 1``), ``--precompile`` with ``--paged`` (as the JAX server) and
``--platform gpu`` without a card exit 1. ``--precompile`` on the dense
engine: ``tests/test_torch_tools.py``.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import pytest
import torch

from conftest import TOKENIZER_BIN
from llama2_tpu_torch.config import GenerationConfig
from llama2_tpu_torch.io.checkpoint import load_checkpoint
from llama2_tpu_torch.runtime import server as srv
from llama2_tpu_torch.runtime.batch_engine import BatchEngine
from llama2_tpu_torch.runtime.generator import Generator
from llama2_tpu_torch.runtime.paged_engine import PagedBatchEngine
from llama2_tpu_torch.tokenizer.tokenizer import Tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _start(engine, tokenizer):
    class Handler(srv._Handler):
        pass

    Handler.engine = engine
    Handler.tokenizer = tokenizer
    engine.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_port}"


@pytest.fixture(scope="module", params=["dense", "paged"])
def server(request, tiny_checkpoint):
    path, _, _ = tiny_checkpoint
    config, params, _ = load_checkpoint(path)
    if request.param == "dense":
        engine = BatchEngine(config, params, batch_size=2, backend="torch", device="cpu")
    else:
        engine = PagedBatchEngine(config, params, batch_size=2, page_size=8, n_pages=32,
                                  prefix_cache=True, backend="cuda", device="cpu")
    tokenizer = Tokenizer.from_file(TOKENIZER_BIN, config.vocab_size)
    httpd, url = _start(engine, tokenizer)
    yield url, request.param, config, params, tokenizer
    httpd.shutdown()
    httpd.server_close()
    engine.stop()


def _post(url, obj, timeout=240):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_health(server):
    url = server[0]
    code, body = _get(url + "/health")
    assert code == 200 and body["status"] == "ok" and body["slots"] == 2
    assert body["active"] >= 0 and body["waiting"] >= 0


def test_generate_equals_generator(server):
    url, _, config, params, tokenizer = server
    code, body = _post(url + "/generate", {"prompt": "a b", "temperature": 0.0, "steps": 12})
    assert code == 200, body
    prompt = tokenizer.encode("a b")
    want = Generator(config, params, backend="torch", device="cpu").generate(
        prompt, GenerationConfig(temperature=0.0, steps=12)).tokens
    assert body["tokens"] == want and body["prompt_len"] == len(prompt)
    assert body["text"] == tokenizer.decode(want).decode("utf-8", errors="replace")
    assert body["ttft_ms"] > 0 and body["total_ms"] >= body["ttft_ms"]


def test_generate_deterministic(server):
    url = server[0]
    a = _post(url + "/generate", {"prompt": "a", "temperature": 0.0, "steps": 8})[1]
    b = _post(url + "/generate", {"prompt": "a", "temperature": 0.0, "steps": 8})[1]
    assert a["tokens"] == b["tokens"]
    s1 = _post(url + "/generate", {"prompt": "a", "temperature": 0.8, "steps": 8, "seed": 5})[1]
    s2 = _post(url + "/generate", {"prompt": "a", "temperature": 0.8, "steps": 8, "seed": 5})[1]
    assert s1["tokens"] == s2["tokens"]


def test_concurrent_requests(server):
    url = server[0]
    results = {}

    def hit(i):
        results[i] = _post(url + "/generate", {"prompt": "a", "temperature": 0.0, "steps": 6 + i})

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert len(results) == 4
    for i, (code, body) in results.items():
        assert code == 200 and len(body["tokens"]) <= 6 + i


def test_bad_json(server):
    req = urllib.request.Request(server[0] + "/generate", data=b"{not json",
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


def test_bad_params(server):
    code, body = _post(server[0] + "/generate", {"prompt": "a", "temperature": "hot"})
    assert code == 400 and "bad parameter" in body["error"]
    code, body = _post(server[0] + "/generate", {"prompt": 5})
    assert code == 400
    code, body = _post(server[0] + "/generate", {"prompt": "a", "seed": "x"})
    assert code == 400


def test_unknown_codepoint_is_400(server):
    code, _ = _post(server[0] + "/generate", {"prompt": "\U0001F600"})
    assert code == 400


def test_metrics(server):
    url, kind = server[:2]
    prompt = "a b c d e f g h i j k l m n o p q r"  # two full pages of 8 rows
    for _ in range(2):
        _post(url + "/generate", {"prompt": prompt, "temperature": 0.0, "steps": 40})
    code, body = _get(url + "/metrics")
    assert code == 200 and body["requests"] >= 2 and body["tokens"] >= 1
    assert body["ttft_p50_ms"] >= 0 and body["prefill_p50_ms"] >= 0
    if kind == "paged":
        assert body["prefix_hit_pages"] >= 1 and body["prefix_cached_pages"] >= 1
    else:
        assert "prefix_hit_pages" not in body


def test_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server[0] + "/nope", timeout=30)
    assert e.value.code == 404
    code, _ = _post(server[0] + "/nope", {})
    assert code == 404


# --paged --mesh serves now: its case is a malformed mesh; --collective-matmul needs --mesh
@pytest.mark.parametrize("flag", [["--spec", "1"], ["--mesh", "2x", "--paged"], ["--collective-matmul"],
                                  ["--precompile", "16", "--paged"], ["--kernels", "pallas"],
                                  ["--prefix-cache"], ["--bogus"]])
def test_unported_and_bad_flags_exit_1(tiny_checkpoint, capsys, flag):
    path, _, _ = tiny_checkpoint
    assert srv.main([path, "--platform", "cpu", *flag]) == 1
    err = capsys.readouterr().err
    assert flag[0] in err or "--prefix-cache requires --paged" in err


def test_entry_point_serves_with_spec_on_the_cpu(tiny_checkpoint):
    """``--spec 4`` on the dense engine: the greedy answer equals the
    Generator's tokens (the windows emit the plain greedy stream)."""
    path, _, _ = tiny_checkpoint
    cmd = [sys.executable, "-m", "llama2_tpu_torch.runtime.server", path, "-z", TOKENIZER_BIN,
           "--platform", "cpu", "--port", "0", "--spec", "4", "--ticks-per-sync", "2",
           "--kernels", "torch", "--batch-size", "2"]
    proc = subprocess.Popen(cmd, cwd=REPO, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        m = re.search(r"http://[\d.]+:\d+", line)
        assert m, line
        code, body = _post(m.group(0) + "/generate", {"prompt": "a b", "temperature": 0.0, "steps": 21})
        assert code == 200, body
        config, params, _ = load_checkpoint(path)
        tok = Tokenizer.from_file(TOKENIZER_BIN, config.vocab_size)
        want = Generator(config, params, backend="torch", device="cpu").generate(
            tok.encode("a b"), GenerationConfig(temperature=0.0, steps=21)).tokens
        assert body["tokens"] == want
    finally:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
        proc.stderr.close()


def test_gpu_platform_without_a_card_exits_1(tiny_checkpoint, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path, _, _ = tiny_checkpoint
    assert srv.main([path, "-z", TOKENIZER_BIN]) == 1
    assert "--platform cpu" in capsys.readouterr().err


def test_entry_point_serves_on_the_cpu(tiny_checkpoint):
    """``python -m llama2_tpu_torch.runtime.server`` with ``--paged
    --prefix-cache``: it prints its address, answers a greedy request with the
    Generator's tokens, and stops on SIGINT."""
    path, _, _ = tiny_checkpoint
    cmd = [sys.executable, "-m", "llama2_tpu_torch.runtime.server", path, "-z", TOKENIZER_BIN,
           "--platform", "cpu", "--port", "0", "--paged", "--page-size", "8", "--prefix-cache",
           "--kernels", "torch", "--batch-size", "2"]
    proc = subprocess.Popen(cmd, cwd=REPO, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        m = re.search(r"http://[\d.]+:\d+", line)
        assert m, line
        code, body = _post(m.group(0) + "/generate", {"prompt": "a", "temperature": 0.0, "steps": 9})
        assert code == 200, body
        config, params, _ = load_checkpoint(path)
        tok = Tokenizer.from_file(TOKENIZER_BIN, config.vocab_size)
        want = Generator(config, params, backend="torch", device="cpu").generate(
            tok.encode("a"), GenerationConfig(temperature=0.0, steps=9)).tokens
        assert body["tokens"] == want
    finally:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
        proc.stderr.close()
