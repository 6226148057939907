"""Closed loop, one caller: batches of ``batch`` queries, each the next
slice of the query pool, dispatched back to back. The window closes on a
device synchronise after the batch that crosses ``--seconds``, so only
finished work counts: ``qps`` is every query of the window over its
seconds."""

from __future__ import annotations

import time

import torch

from portbench.check import Answers

WARM_BATCHES = 2


def _slices(run):
    b = int(run.traffic["batch"])
    return b, int(run.pool.shape[0]) // b


def prepare(run) -> None:
    b, n = _slices(run)
    for i in range(WARM_BATCHES):
        off = (i % n) * b
        run.search(run.pool[off:off + b])
    run.sync()


def measure(run):
    b, n = _slices(run)
    outs, traced, ends = [], [], []
    run.sync()
    t_open = time.perf_counter()
    run.tracer.start()
    i = 0
    while True:
        off = (i % n) * b
        d, ids = run.search(run.pool[off:off + b])
        outs.append((off, d, ids))
        ends.append(time.perf_counter())
        if run.tracer.active:
            traced.append(off)
            if run.tracer.due():
                run.tracer.stop(run.sync)
        i += 1
        if time.perf_counter() - t_open >= run.seconds:
            break
    run.sync()
    t_close = time.perf_counter()
    run.tracer.stop(run.sync)
    dev = run.pool.device
    qidx = torch.cat([off + torch.arange(b, device=dev) for off, _, _ in outs])
    answers = Answers(qidx, torch.cat([d for _, d, _ in outs]).to(torch.float32),
                      torch.cat([ids for _, _, ids in outs]).to(torch.int64))
    return dict(t_open=t_open, t_close=t_close, attempted=i * b, answers=answers, batches=i,
                traced_slices=traced, batch=b, batch_ends=ends)
