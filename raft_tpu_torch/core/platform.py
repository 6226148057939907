"""Several ranks on one machine: the stand-in for a multi-device mesh.

Counterpart of raft_tpu/core/platform.py. The JAX package stands in several
devices on the CPU by forcing XLA's host platform to ``n`` virtual devices
(``force_virtual_cpu``), since its mesh lives inside one process. PyTorch
runs one process per device, so here the stand-in is a world of ``n``
spawned ranks: :class:`RankPool` starts them (on ``"cpu"`` with gloo, or on
a named device such as ``"cuda:0"``, where several ranks share the card
through gloo), each joins the world through
:func:`raft_tpu_torch.comms.bootstrap.initialize`, and then each runs one
pickled task after another: :meth:`RankPool.run` sends the same call to
every rank and returns their results in rank order. A test file pays one
spawn for all its cases.

Ranks are spawned, never forked (the caller may hold threads or a CUDA
context). Every world has a collective timeout, so a rank that dies fails
its peers' collectives instead of hanging them, and :meth:`RankPool.run`
waits no longer than that timeout. :meth:`RankPool.close` leaves the world
on every rank (``destroy_process_group``), joins every rank and starts no
thread of its own. A task's tensors come back on the host.

Reference analogue: the LocalCUDACluster self-bootstrap of the reference's
raft-dask test conftest (python/raft-dask/raft_dask/test/conftest.py).
"""

from __future__ import annotations

import contextlib
import multiprocessing
import socket
import time
import traceback

from .errors import RaftError, expects

__all__ = ["RankPool", "force_virtual_cpu", "virtual_cpu_env"]

# seconds the pool still waits for the other ranks once one has failed
ERROR_GRACE_S = 10.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host(out):
    """A task's result with every tensor moved to the host (a CUDA tensor
    would otherwise cross the pipe as an IPC handle)."""
    import torch

    if isinstance(out, torch.Tensor):
        return out.detach().cpu()
    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)) and not hasattr(out, "_fields"):
        return type(out)(_to_host(v) for v in out)
    return out


def _rank_main(conn, rank: int, world: int, port: int, device: str, backend,
               timeout_s: float, threads: int) -> None:
    """A rank's process (spawn target): join the world, then run tasks until
    the pool sends ``None`` or goes away."""
    try:
        import torch

        if threads:
            torch.set_num_threads(threads)
        from ..comms import bootstrap

        bootstrap.initialize(f"127.0.0.1:{port}", world, rank, backend=backend,
                             device=device, timeout_s=timeout_s)
        conn.send(("ready", rank))
    except BaseException:
        conn.send(("err", traceback.format_exc()))
        return
    try:
        while True:
            try:
                task = conn.recv()
            except EOFError:
                break
            if task is None:
                break
            fn, args, kwargs = task
            try:
                conn.send(("ok", _to_host(fn(*args, **kwargs))))
            except Exception:
                conn.send(("err", traceback.format_exc()))
    finally:
        bootstrap.shutdown()
        conn.close()


class RankPool:
    """``n_ranks`` spawned processes forming one ``torch.distributed`` world
    on ``device`` (``"cpu"``, ``"cuda"`` for one card a rank, or a named
    card all ranks share). ``backend`` defaults as
    :func:`~raft_tpu_torch.comms.bootstrap.initialize` does (pass
    ``"gloo"`` for ranks that share a card). ``timeout_s`` bounds the boot,
    each task and every collective. ``threads`` caps each rank's torch
    threads (0: torch's default). Use as a context manager or call
    :meth:`close`."""

    def __init__(self, n_ranks: int, device: str = "cpu", backend: str | None = None,
                 timeout_s: float = 300.0, threads: int = 1):
        expects(n_ranks >= 1, "a world needs at least one rank, got %d", n_ranks)
        self.n_ranks = int(n_ranks)
        self.device = str(device)
        self.timeout_s = float(timeout_s)
        self._procs, self._conns = [], []
        ctx = multiprocessing.get_context("spawn")
        port = _free_port()
        t0 = time.perf_counter()
        try:
            for r in range(self.n_ranks):
                parent, child = ctx.Pipe()
                p = ctx.Process(target=_rank_main, name=f"raft-rank-{r}", daemon=True,
                                args=(child, r, self.n_ranks, port, self.device, backend,
                                      self.timeout_s, threads))
                p.start()
                child.close()
                self._procs.append(p)
                self._conns.append(parent)
            self._collect("boot")
        except BaseException:
            self.close()
            raise
        self.boot_s = time.perf_counter() - t0

    def _collect(self, what: str) -> list:
        """One message from every rank, in rank order. Raises if a rank
        failed (after the others answered, or within ``ERROR_GRACE_S`` of the
        failure: a peer may wait on the failed rank in a collective), died,
        or did not answer within the timeout; a rank that never answered
        closes the pool."""
        from multiprocessing.connection import wait

        out, errors = [None] * len(self._conns), []
        pending = dict(enumerate(self._conns))
        deadline = time.monotonic() + self.timeout_s
        while pending:
            ready = wait(list(pending.values()), max(deadline - time.monotonic(), 0.0))
            if not ready:
                break
            for r in [r for r, c in pending.items() if c in ready]:
                try:
                    tag, value = pending.pop(r).recv()
                except EOFError:
                    tag, value = "err", f"rank {r} died"
                if tag == "err":
                    errors.append(f"rank {r}:\n{value}")
                    deadline = min(deadline, time.monotonic() + ERROR_GRACE_S)
                out[r] = value
        if pending:
            self.close()
            errors += [f"rank {r} did not answer its {what} within its time"
                       for r in pending]
        if errors:
            raise RaftError(f"{what} failed on {len(errors)} rank(s):\n" + "\n".join(errors))
        return out

    def run(self, fn, *args, **kwargs) -> list:
        """Call ``fn(*args, **kwargs)`` on every rank (``fn`` must pickle:
        a module-level function) and return the results in rank order."""
        expects(self._conns, "the rank pool is closed")
        for conn in self._conns:
            conn.send((fn, args, kwargs))
        return self._collect(getattr(fn, "__name__", "task"))

    def close(self) -> None:
        """Leave the world on every rank and join every rank (idempotent)."""
        for conn in self._conns:
            with contextlib.suppress(OSError, ValueError):
                conn.send(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def force_virtual_cpu(n_devices: int, **kwargs) -> RankPool:
    """``n_devices`` ranks of a gloo world on the CPU (the JAX function's
    name: its ``n`` virtual devices). The caller closes the pool."""
    return RankPool(n_devices, device="cpu", **kwargs)


@contextlib.contextmanager
def virtual_cpu_env(n_devices: int, **kwargs):
    """:func:`force_virtual_cpu` for the span of a ``with`` block."""
    pool = force_virtual_cpu(n_devices, **kwargs)
    try:
        yield pool
    finally:
        pool.close()
