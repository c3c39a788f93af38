"""The port's kernel microbenchmarks (``llama2_tpu_torch/benchmarks``) on the
CPU: every suite runs at tiny shapes with the host's clock and prints its
lines in the stated format; the suites are the JAX file's
(``benchmarks/kernels.py::ALL``) plus ``paged``; the entry point runs with
``--platform cpu`` and fails with no card without it. Times measured here are
the host's and say nothing of the card.
"""

import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from llama2_tpu_torch.benchmarks import kernels, timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"^(?P<name>\S.*?) +(?P<us>\d+\.\d\d) us/op"
                  r"(?:  +\d+\.\d GB/s  \(host\))?(?:  +\d+\.\d\d TFLOP/s)?$")

# each suite at tiny shapes, and the lines it prints: (kwargs, shapes, variants)
TINY = {
    "rmsnorm": ({"shapes": ((3, 64), (2, 72))}, 2, 2),
    "swiglu": ({"shapes": ((3, 64), (2, 70))}, 2, 2),
    "quant_matmul": ({"shapes": ((1, 128, 64), (3, 128, 64))}, 2, 2),
    "attention": ({"cases": ((64, 63), (64, 10)), "B": 2, "H": 4, "KVH": 2, "hs": 32}, 2, 2),
    "attention_stacked": ({"positions": (20, 5), "L": 2, "B": 2, "KVH": 2, "S": 32, "hs": 32}, 4, 2),
    "mlp_block": ({"L": 2, "D": 128, "HD": 192, "B": 2, "group": 32}, 1, 2),
    "prefill": ({"cases": ((32, 16), (64, 16)), "H": 4, "KVH": 2, "hs": 32}, 2, 2),
    "sample": ({"V": 100}, 1, 3),
    "paged": ({"positions": (5, 20), "B": 2, "H": 4, "KVH": 2, "hs": 32, "page": 8, "S": 32}, 10, 2),
}


def test_suites_are_the_jax_files_plus_paged():
    spec = importlib.util.spec_from_file_location("jax_kernel_benchmarks",
                                                  os.path.join(REPO, "benchmarks", "kernels.py"))
    jax_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_bench)
    assert list(kernels.SUITES) == [*jax_bench.ALL, "paged"]
    assert set(TINY) == set(kernels.SUITES)


@pytest.mark.parametrize("suite", list(TINY))
def test_suite_runs_on_cpu_and_prints_its_lines(suite):
    kwargs, shapes, variants = TINY[suite]
    out = io.StringIO()
    b = kernels.Bench("cpu", iters=2, stream_bytes=0, out=out)
    kernels.SUITES[suite](b, **kwargs)
    lines = out.getvalue().splitlines()
    assert len(lines) == shapes * variants, lines
    for line in lines:
        m = LINE.match(line)
        assert m, line
        assert float(m["us"]) > 0
        assert "%" not in line  # no share of the card's rates from a CPU run


def test_rotation_covers_the_stream_bytes():
    b = kernels.Bench("cpu", stream_bytes=512 * 2**20)
    assert b.copies(4 * 2**20) == 128 and b.copies(600 * 2**20) == 1
    case = kernels.rmsnorm_case(kernels.Bench("cpu", stream_bytes=10_000), 4, 64)
    assert case.copies == -(-10_000 // case.nbytes) and case.inputs["x"].shape[0] == case.copies


def test_time_ms_on_the_host():
    calls = []
    ms, queued = timing.time_ms(calls.append, 5, None, n_warm=2)
    assert ms >= 0 and not queued and calls == [0, 1, 0, 1, 2, 3, 4]


def test_entry_point_on_cpu():
    r = subprocess.run([sys.executable, "-m", "llama2_tpu_torch.benchmarks.kernels", "sample",
                        "--platform", "cpu", "--iters", "2"], capture_output=True, text=True,
                       timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("cpu")
    assert [LINE.match(x)["name"] for x in lines[1:-1]] == [
        "sample[32000] argmax", "sample[32000] multinomial", "sample[32000] top_p 0.9 (full sort)"]
    launches = json.loads(lines[-1])["launches"]
    assert set(launches) == set(kernels.KERNELS) and not any(launches.values())


def test_entry_point_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernels.main(["sample"])
