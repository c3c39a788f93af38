"""Timing of calls on the card with CUDA events, queued behind a device sleep
so that the host's launch rate does not set the time; the host's clock for
calls on the CPU."""

from __future__ import annotations

import time

import torch


def sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per device millisecond."""
    cycles = 10**7
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def warm_cycles_per_ms() -> float:
    """:func:`sleep_cycles_per_ms` on a card brought to its working clock
    first (half a second of device sleep), the largest of three readings: a
    reading at an idle clock makes the sleeps that hold the timed calls
    (:func:`time_ms`) too short, and the calls then run as the host issues
    them."""
    torch.cuda._sleep(int(1e9))
    torch.cuda.synchronize()
    return max(sleep_cycles_per_ms() for _ in range(3))


def time_ms(fn, n_iter: int, cycles_per_ms: float | None, n_warm: int = 3,
            slack: float = 1.5) -> tuple[float, bool]:
    """Mean ms per call of ``fn(i)`` over ``n_iter`` calls, after ``n_warm``
    warm-up calls, and whether the calls were queued ahead.

    On the card (``cycles_per_ms`` from :func:`sleep_cycles_per_ms`): one
    Python call takes tens of microseconds on the host, longer than a short
    kernel runs, so events around calls issued one by one would time the
    host's launch rate. The stream is first held by a device sleep longer
    than the host takes to send the calls (``slack`` times the time a first
    round took): the events then see the calls back to back. A function that
    waits on the device inside (the plain K2 reads ``pos`` on the host) cannot
    be queued ahead, and its time includes the host's gaps; the second value
    says which case it was.

    ``cycles_per_ms=None``: the calls run on the CPU, timed by the host's
    clock (never queued); such a time is the host's, not the card's.
    """
    for i in range(n_warm):
        fn(i)
    if cycles_per_ms is None:
        t0 = time.perf_counter()
        for i in range(n_iter):
            fn(i)
        return (time.perf_counter() - t0) * 1e3 / n_iter, False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_iter):
        fn(i)
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((slack * issue_ms + 1.0) * cycles_per_ms))
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    queued = not start.query()  # the device had not reached the first call yet
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter, queued
