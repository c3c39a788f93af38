"""Process groups and the rank launcher.

Counterpart of ``llama2_tpu/parallel/distributed.py``. Where JAX wires hosts
into one runtime, here every rank is a process of its own in one
``torch.distributed`` group:

    from llama2_tpu_torch.parallel import distributed
    distributed.initialize()   # from the environment, as torchrun sets it; on the card
    # or explicitly:
    distributed.initialize("file:///tmp/rdv", world_size=2, rank=r, device="cuda")

    # or spawn the ranks of a dp x tp mesh from one process:
    results = distributed.launch(fn, dp, tp, "cpu", *args)  # fn(mesh, *args) on each rank
    # a (seq, model) or (stage, model) mesh: the leading axis named
    results = distributed.launch(fn, sp, tp, "cpu", *args, axis="seq")

The collective backend follows from the ranks and the cards
(:func:`backend_rule`): NCCL where every rank owns a card of its own (rank
``r`` on ``cuda:r``), gloo where ranks share a card (NCCL refuses two ranks
on one GPU; the tensors stay on the card, only the transport goes through
the host) or run on the CPU. The choice is printed, never found by catching
an error. Every group takes a short timeout, so that a dead rank fails the
others instead of hanging them, and :func:`launch` joins its ranks with a
deadline and kills them all on the first failure.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 120.0  # a collective that waits longer than this fails
DEFAULT_DEADLINE_S = 900.0  # what launch() gives its ranks, all together

# what the engines launch on the card, built once before the ranks start
# (runtime/batch_engine.py::kernel_libraries over every cache kind, and the
# paged engine's attention)
ENGINE_LIBRARIES = ("prefill_attention", "decode_attention", "attention_q8", "quant_matmul", "mlp_block",
                    "paged_attention")


class RankError(RuntimeError):
    """A rank of :func:`launch` failed; the message holds its traceback."""


def backend_rule(world: int, device_type: str, cards: int | None = None) -> tuple[str, str]:
    """``(backend, reason)`` for ``world`` ranks on ``device_type``: NCCL
    when each rank owns a card (``world <= cards``), else gloo. ``cards``
    defaults to ``torch.cuda.device_count()``."""
    if device_type != "cuda":
        return "gloo", f"[mesh] {world} ranks on the CPU: gloo"
    cards = torch.cuda.device_count() if cards is None else cards
    if world <= cards:
        return "nccl", f"[mesh] {world} ranks on {cards} cards, one each: nccl"
    where = "cuda:0" if cards == 1 else f"{cards} cards"
    return "gloo", f"[mesh] {world} ranks share {where}: gloo"


def rank_device(rank: int, device_type: str) -> torch.device:
    """The device of ``rank``: ``cuda:rank`` over as many cards as there
    are (so every rank on ``cuda:0`` with one card), or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    device=None,
    backend: str | None = None,
    timeout: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the process group: from ``WORLD_SIZE`` / ``RANK`` and torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT`` (``init_method`` ``env://``) where the
    arguments are not given. ``device``: the ranks' device type, None
    meaning the card (the port's rule: without one it raises, and the CPU
    must be asked for). A no-op when the group is up already or the world
    is one rank. ``backend`` defaults to :func:`backend_rule`'s, and its
    reason is printed."""
    from llama2_tpu_torch.runtime.generator import resolve_device

    device_type = resolve_device(device).type
    if dist.is_initialized():
        return
    world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
    if world_size <= 1:
        return
    rank = int(os.environ["RANK"]) if rank is None else rank
    if backend is None:
        backend, why = backend_rule(world_size, device_type)
        if rank == 0:
            print(why, file=sys.stderr, flush=True)
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(rank, device_type))
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout),
    )


def _rank_main(fn, rank: int, dp: int, tp: int, axis: str, init_method: str, backend: str, device_type: str,
               timeout: float, results, args_path: str) -> None:
    """One rank of :func:`launch`: join the group, build the mesh, run
    ``fn(mesh, *args)`` (``args`` read from the file the launcher wrote)
    and post ``(rank, ok, value or traceback)``."""
    from llama2_tpu_torch.parallel.mesh import make_mesh

    if device_type == "cpu":
        # one thread a rank: the ranks share the host's cores
        torch.set_num_threads(1)
    try:
        initialize(init_method, dp * tp, rank, device_type, backend, timeout)
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        value = fn(make_mesh(dp, tp, device_type, axis), *args)
        results.put((rank, True, value))
    except BaseException:  # noqa: BLE001 -- reported to the launcher, which raises
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_context():
    """``spawn``, never ``fork``: the parent may have threads running."""
    import torch.multiprocessing as mp

    return mp.get_context("spawn")


def launch(fn, dp: int, tp: int, device, *args, axis: str = "data", deadline: float = DEFAULT_DEADLINE_S,
           timeout: float = DEFAULT_TIMEOUT_S, libraries=ENGINE_LIBRARIES) -> list:
    """Run ``fn(mesh, *args)`` on each of ``dp * tp`` spawned ranks and
    return their values (picklable host values), rank 0's first. ``mesh``
    is the rank's ``(axis, model)`` mesh: ``dp`` is the size of the leading
    axis, ``data`` (the default), ``seq`` or ``stage``.

    The ranks meet through a ``file://`` rendezvous in a new temporary
    directory (no port to race for), where ``args`` are written once for
    every rank to read: sent down a rank's start pipe, a large argument
    would hold the next rank's start until this one had imported ``fn``'s
    module. On the card the kernel ``libraries``
    are built here once first, so that the ranks load them and do not each
    run the builds. The first rank to fail, or a rank that dies, ends every
    rank, and its error is raised as :class:`RankError`; past ``deadline``
    seconds the ranks are killed and ``TimeoutError`` raised."""
    world = dp * tp
    device_type = torch.device(device).type
    backend, why = backend_rule(world, device_type)
    print(why, file=sys.stderr, flush=True)
    if device_type == "cuda" and libraries:
        from llama2_tpu_torch.ops.cuda import build

        build.build_all(list(libraries))
    ctx = spawn_context()
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="llama2-mesh-")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    args_path = os.path.join(tmp, "args.pkl")
    with open(args_path, "wb") as f:
        pickle.dump(args, f, protocol=pickle.HIGHEST_PROTOCOL)
    procs = [
        ctx.Process(target=_rank_main, daemon=True,
                    args=(fn, r, dp, tp, axis, init_method, backend, device_type, timeout, results, args_path))
        for r in range(world)
    ]
    try:
        for p in procs:
            p.start()
        return _collect(procs, results, time.monotonic() + deadline)
    finally:
        for p in procs:
            if p.pid is None:  # never started: an earlier start failed
                continue
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def _collect(procs, results, end: float) -> list:
    """Every rank's value, or the first failure raised."""
    got: dict = {}
    while len(got) < len(procs):
        try:
            rank, ok, value = results.get(timeout=0.1)
        except queue.Empty:
            for r, p in enumerate(procs):
                if r not in got and p.exitcode not in (None, 0):
                    raise RankError(f"rank {r} died with exit code {p.exitcode}") from None
            if time.monotonic() > end:
                raise TimeoutError(f"ranks {sorted(set(range(len(procs))) - set(got))} did not finish "
                                   "before the deadline") from None
            continue
        if not ok:
            raise RankError(f"rank {rank} failed:\n{value}")
        got[rank] = value
    for p in procs:
        p.join(timeout=max(1.0, end - time.monotonic()))
    return [got[r] for r in range(len(procs))]
