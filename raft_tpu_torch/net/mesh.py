"""Multi-process mesh: shard groups owned by worker processes behind a
router, scatter-gather crossing process boundaries candidates-only.

The port's counterpart of raft_tpu/net/mesh.py. Each ``(shard, replica)``
pair is a separate OS process owning its shard's rows — a sealed
brute-force index wrapped in a :class:`~raft_tpu_torch.stream.MutableIndex`
carrying the GLOBAL ids, published into a process-local
:class:`~raft_tpu_torch.serve.SearchService` behind its own
:class:`~raft_tpu_torch.net.server.NetServer`. The router
(:class:`ProcessMesh`) is submit-shaped, so the same front door (and the
same client retry discipline) serves a process fleet exactly as it
serves one service.

Contracts, in order of importance:

- **candidates-only on the wire** — a scatter part returns k global ids
  + k distances per query row, NEVER raw vectors; the router merges
  parts host-side with numpy (ascending distances — the brute-force L2
  convention, the JAX package's ``argpartition`` + stable ``argsort``, so
  ties across shards break as there) and truncates to k. Rows cross the
  wire once, at load time.
- **kill-a-worker is a strike→fence→failover event, not an outage** —
  per-worker breakers mirror the
  :class:`~raft_tpu_torch.stream.replicated.FencingPolicy` semantics: a
  connection-level failure strikes the worker, fences it for a doubling
  backoff, and the SAME scatter call retries the surviving twin in the
  group. Expired fences are half-open probes; a success unfences. Only
  a group at zero pickable workers raises
  :class:`~raft_tpu_torch.serve.errors.ReplicaUnavailableError` (that IS
  an outage). Fences and failovers journal as ``net_worker_*`` events and
  count in ``raft_tpu_net_worker_*_total``.
- **routing is the shared hash** — rows land on shard
  ``stream.shard_of(ids, n_shards)``, the SplitMix64 contract a router
  in front of a real fleet shares with the build side; writes route by
  the same hash and apply to EVERY replica of the owning group (twins
  stay twins).
- **the worker's device is explicit** — :attr:`MeshSpec.device` (default
  ``"cuda"``) reaches every worker in its spawn spec and the worker builds
  through ``Resources(device=...)``; a worker that finds no CUDA device
  fails its boot with its traceback (it never falls back to the CPU).
  Workers are spawned, never forked: the router may hold a CUDA context.
- **zero kernel builds on the wire path** — on ``cuda`` the router builds
  the kernel libraries a brute-force worker launches (``fused_knn``,
  ``fused_knn_tc``) before it spawns anyone and hands each worker its
  build directory, so every worker loads them from the cache (no nvcc
  run, and no two workers compiling one source); each worker then
  rehearses the warm-before-flip publish ladder at boot, settles the
  first-call path, and only then opens its build-attribution window. The
  router's :meth:`~ProcessMesh.stats` sums the window's
  ``compile_s``/``cache_misses``, the boot's, and each worker's kernel
  launches (counted inside the worker, which is where they happen).

Validation errors (bad shape/dim/k — a 400 from any worker) raise
without striking: every twin would refuse identically, and a caller-side
bug must not fence the fleet. ``OverloadedError`` / ``DeadlineExceededError``
pass through untouched — backpressure belongs to the client's retry
policy, not the router's breaker.
"""

from __future__ import annotations

import functools
import multiprocessing
import os
import threading
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from .. import ops
from ..core.errors import RaftError, expects
from ..obs import events as obs_events
from ..obs import metrics
from ..serve.errors import (DeadlineExceededError, OverloadedError,
                            ReplicaUnavailableError, ServeError)
from .client import NetClient

__all__ = ["MeshSpec", "ProcessMesh"]


@functools.lru_cache(maxsize=None)
def _c_fenced():
    return metrics.counter(
        "raft_tpu_net_worker_fenced_total",
        "mesh worker processes fenced after a strike (connection-level "
        "or server-side failure) — each co-journals net_worker_fenced")


@functools.lru_cache(maxsize=None)
def _c_failovers():
    return metrics.counter(
        "raft_tpu_net_worker_failovers_total",
        "scatter parts retried on a surviving twin in the SAME call "
        "after the picked worker failed — each co-journals "
        "net_worker_failover")


@dataclass(frozen=True)
class MeshSpec:
    """Topology + per-worker serving config for a :class:`ProcessMesh`.
    ``device`` is where every worker builds and serves its shard
    (``"cuda"``, or ``"cpu"`` for tests)."""

    n_shards: int = 2
    n_replicas: int = 1
    name: str = "corpus"
    ks: tuple = (10,)
    max_batch: int = 64
    max_queue_rows: int = 4096
    host: str = "127.0.0.1"
    start_timeout_s: float = 120.0
    # breaker: strikes before fencing, initial fence backoff, cap
    max_consecutive: int = 1
    fence_backoff_s: float = 0.5
    max_backoff_s: float = 8.0
    device: str = "cuda"


# the kernel libraries a brute-force worker launches: mode f32's row-split
# route (every flush up to M_SMALL rows) and the tensor-core file's batch
# route and split (a mutable flush past M_SMALL)
WORKER_KERNELS = ("fused_knn", "fused_knn_tc")
KILL_WAIT_S = 120.0     # kill_worker's wait for the process to be gone


def _worker_main(conn, rows_conn, spec: dict) -> None:
    """Worker process entry (spawn target). Boots a shard replica on
    ``spec["device"]``: build → wrap with global ids → publish (the warm
    ladder) → settle → open the build-attribution window → serve. Its
    rows and global ids arrive as raw buffers on ``rows_conn``, a one-way
    pipe, not in ``spec``: a spawn argument is written before ``start()``
    returns, so large arguments would make the boots run one after
    another (and the duplex ``conn``, a socket pair, moved 256 MB in ~30 s
    on an H100 host where a pipe moved it in ~3 s). Reports
    ``{"port", "pid",
    "boot_s"}`` (or ``{"error": tb}``) over the pipe, then blocks on it for
    stop. ``boot_s`` is the wall from the router's spawn to serving: the
    interpreter's start and imports, the device context, the build and the
    warm ladder; ``boot_steps`` splits it (seconds since the spawn when
    the entry ran, the rows arrived, the imports and the build were done
    and the warm ladder had run)."""
    steps = {"entered": time.time() - spec["spawned_at"]}
    try:
        n_rows, dim = rows_conn.recv()
        rows = np.empty((n_rows, dim), np.float32)
        ids = np.empty((n_rows,), np.int64)
        rows_conn.recv_bytes_into(rows.reshape(-1))  # 1-D: the size check
        rows_conn.recv_bytes_into(ids)
        rows_conn.close()
        steps["rows_received"] = time.time() - spec["spawned_at"]
        import torch

        from ..core.resources import Resources
        from ..neighbors import brute_force
        from ..obs import compile as obs_compile
        from ..obs.requestlog import RequestLog
        from ..ops import _build
        from ..serve.service import SearchService
        from ..stream.mutable import MutableIndex
        from .server import NetServer

        if spec["build_dir"] is not None:
            # the router's build directory: its libraries are already
            # there, so this worker loads them and runs no nvcc
            _build.set_build_dir(spec["build_dir"])
        if torch.device(spec["device"]).type == "cpu":
            # four CPU workers beside the caller: one thread each
            torch.set_num_threads(1)
        res = Resources(device=spec["device"])  # no card: RaftError here
        name = spec["name"]
        steps["imported"] = time.time() - spec["spawned_at"]
        with obs_compile.attribution() as boot:
            idx = MutableIndex(brute_force.BruteForce().build(rows, res=res),
                               ids=ids, name=name)
            steps["built"] = time.time() - spec["spawned_at"]
            rlog = RequestLog()
            svc = SearchService(max_batch=spec["max_batch"],
                                max_queue_rows=spec["max_queue_rows"],
                                request_log=rlog)
            svc.publish(name, idx, k=tuple(spec["ks"]))  # warm-before-flip
            # settle any residual first-call host paths OUTSIDE the window
            for k in spec["ks"]:
                svc.search(name, rows[:1], int(k))
        steps["warmed"] = time.time() - spec["spawned_at"]
        base = ops.launch_counts()
        with obs_compile.attribution() as rec:
            def stats():
                now = ops.launch_counts()
                return {"pid": os.getpid(), "device": str(res.device),
                        "compile_s": rec.compile_s,
                        "cache_misses": rec.cache_misses,
                        "boot_compile_s": boot.compile_s,
                        "boot_cache_misses": boot.cache_misses,
                        "boot_cache_hits": boot.cache_hits,
                        "rows": int(rows.shape[0]),
                        "launches": {n: now[n] - base[n] for n in now}}

            srv = NetServer(svc, host=spec["host"], request_log=rlog,
                            stats=stats)
            conn.send({"port": srv.port, "pid": os.getpid(),
                       "boot_s": time.time() - spec["spawned_at"],
                       "boot_steps": steps})
            try:
                conn.recv()  # stop signal (or EOF when the router died)
            except EOFError:
                pass
            srv.stop()
            svc.shutdown()
    except Exception:
        try:
            # bounded: a traceback can quote its data, and the router may
            # still be writing this worker's rows
            conn.send({"error": traceback.format_exc()[-8000:]})
        except Exception:
            pass
        raise


@dataclass
class _Worker:
    shard: int
    replica: int
    proc: object
    conn: object
    port: int = 0
    client: NetClient | None = None
    # breaker state (router-side; guarded by the mesh lock)
    fails: int = 0
    fenced_until: float = 0.0
    backoff: float = 0.0
    fenced: bool = False

    @property
    def label(self) -> str:
        return f"s{self.shard}r{self.replica}"


class ProcessMesh:
    """Router over ``n_shards × n_replicas`` worker processes (see
    module doc). Submit-shaped: hand it to a
    :class:`~raft_tpu_torch.net.server.NetServer` as the backend, or call
    :meth:`search` directly."""

    def __init__(self, dataset, ids=None, *, spec: MeshSpec | None = None,
                 clock=time.monotonic):
        from ..stream.sharded import shard_of  # heavy import, router-only

        self.spec = spec or MeshSpec()
        self.name = self.spec.name
        self._clock = clock
        self._lock = threading.Lock()
        # per-shard round-robin seeds: each group rotates independently,
        # so successive searches alternate a group's primary
        # deterministically (a global counter would correlate rotation
        # across shards through thread-arrival order)
        self._rr = [0] * self.spec.n_shards
        dataset = np.asarray(dataset, np.float32)
        expects(dataset.ndim == 2, "dataset must be (rows, d)")
        ids = (np.arange(dataset.shape[0], dtype=np.int64) if ids is None
               else np.asarray(ids, np.int64))
        expects(ids.shape[0] == dataset.shape[0],
                "ids must match dataset rows")
        owner = np.asarray(shard_of(ids, self.spec.n_shards))
        build_dir = self._prebuild()
        ctx = multiprocessing.get_context("spawn")
        self._workers: list[list[_Worker]] = []
        self.boot_s: dict[str, float] = {}
        self.boot_steps: dict[str, dict] = {}
        rows_to = {}
        for s in range(self.spec.n_shards):
            group = []
            for r in range(self.spec.n_replicas):
                parent, child = ctx.Pipe()
                rows_in, rows_out = ctx.Pipe(duplex=False)
                wspec = {"name": self.name, "ks": self.spec.ks,
                         "max_batch": self.spec.max_batch,
                         "max_queue_rows": self.spec.max_queue_rows,
                         "host": self.spec.host, "device": self.spec.device,
                         "build_dir": build_dir, "spawned_at": time.time()}
                p = ctx.Process(target=_worker_main,
                                args=(child, rows_in, wspec), daemon=True,
                                name=f"raft-net-worker-s{s}r{r}")
                p.start()
                child.close()
                rows_in.close()
                group.append(_Worker(s, r, p, parent))
                rows_to[(s, r)] = rows_out
            self._workers.append(group)
        # each worker's rows, once every worker is starting (parallel
        # boots), as raw buffers (``send_bytes`` writes from a memoryview)
        for s, group in enumerate(self._workers):
            rows_s, ids_s = dataset[owner == s], ids[owner == s]
            for w in group:
                out = rows_to.pop((w.shard, w.replica))
                try:
                    out.send(rows_s.shape)
                    out.send_bytes(rows_s)
                    out.send_bytes(ids_s)
                except OSError:
                    pass  # it died before reading: its handshake says why
                finally:
                    out.close()
        # collect handshakes AFTER all workers launched (parallel boots)
        deadline = time.monotonic() + self.spec.start_timeout_s
        for group in self._workers:
            for w in group:
                if not w.conn.poll(max(0.1, deadline - time.monotonic())):
                    self.close()
                    raise RaftError(f"worker {w.label} did not report a "
                                    f"port within "
                                    f"{self.spec.start_timeout_s:g}s")
                try:
                    msg = w.conn.recv()
                except EOFError:
                    msg = {"error": "the worker exited before reporting "
                                    f"(exit code {w.proc.exitcode})"}
                if "error" in msg:
                    self.close()
                    raise RaftError(f"worker {w.label} failed to boot:\n"
                                    f"{msg['error']}")
                w.port = int(msg["port"])
                self.boot_s[w.label] = float(msg["boot_s"])
                self.boot_steps[w.label] = msg["boot_steps"]
                w.client = NetClient(
                    f"http://{self.spec.host}:{w.port}")
        self._pool = ThreadPoolExecutor(
            max_workers=self.spec.n_shards * self.spec.n_replicas,
            thread_name_prefix="raft-net-scatter")
        self._closed = False

    def _prebuild(self) -> str | None:
        """On a card, build (or load from the cache) the libraries the
        workers launch, in this process and before any worker exists, and
        return the build directory to hand them; ``None`` on the CPU, and
        where no card is visible (each worker then fails its own boot)."""
        import torch

        if (torch.device(self.spec.device).type != "cuda"
                or not torch.cuda.is_available()):
            return None
        from ..ops import _build

        _build.build_all(WORKER_KERNELS)
        return str(_build.BUILD_DIR)

    # -- breaker -------------------------------------------------------------
    def _strike(self, w: _Worker, exc: BaseException) -> None:
        with self._lock:
            w.fails += 1
            if w.fails < self.spec.max_consecutive or w.fenced:
                return
            w.fenced = True
            w.backoff = (self.spec.fence_backoff_s if w.backoff == 0.0
                         else min(w.backoff * 2.0, self.spec.max_backoff_s))
            w.fenced_until = self._clock() + w.backoff
        if metrics._enabled:
            _c_fenced().inc(1, shard=f"s{w.shard}")
        obs_events.emit("net_worker_fenced",
                        subject=("net", self.name, w.shard, None),
                        evidence={"worker": w.label,
                                  "backoff_s": w.backoff,
                                  "error": repr(exc)})

    def _observe_ok(self, w: _Worker) -> None:
        with self._lock:
            was_fenced, w.fails, w.backoff, w.fenced = w.fenced, 0, 0.0, False
            w.fenced_until = 0.0
        if was_fenced:
            obs_events.emit("net_worker_unfenced",
                            subject=("net", self.name, w.shard, None),
                            evidence={"worker": w.label})

    def _pick_order(self, shard: int, group: list[_Worker]) -> list[_Worker]:
        """Unfenced workers first (rotated for load spread), then expired
        fences as half-open probes; a still-fenced worker is skipped."""
        now = self._clock()
        with self._lock:
            self._rr[shard] += 1
            rot = self._rr[shard]
            live = [w for w in group if not w.fenced]
            probes = [w for w in group if w.fenced and now >= w.fenced_until]
        live = live[rot % len(live):] + live[:rot % len(live)] if live else []
        return live + probes

    # -- scatter-gather ------------------------------------------------------
    def _scatter_one(self, shard: int, queries, k: int,
                     timeout_s, rid):
        group = self._workers[shard]
        order = self._pick_order(shard, group)
        tried = 0
        last_exc = None
        for w in order:
            tried += 1
            try:
                dists, ids_part, _ = w.client.request(
                    self.name, queries, k, timeout_s=timeout_s, rid=rid)
            except (OverloadedError, DeadlineExceededError):
                # backpressure/deadline: the client's retry policy owns
                # these — the breaker must not fence a merely busy worker
                raise
            except RaftError as exc:
                if isinstance(exc, ServeError):
                    # worker-side failure (closed, 5xx) — strike, failover
                    last_exc = exc
                    self._strike(w, exc)
                    continue
                raise  # validation: every twin refuses identically
            except Exception as exc:  # noqa: BLE001 - connection-level
                last_exc = exc
                self._strike(w, exc)
                continue
            self._observe_ok(w)
            if tried > 1:
                if metrics._enabled:
                    _c_failovers().inc(tried - 1, shard=f"s{shard}")
                obs_events.emit("net_worker_failover",
                                subject=("net", self.name, shard, None),
                                evidence={"retried": tried - 1,
                                          "worker": w.label,
                                          "error": repr(last_exc)})
            return np.asarray(dists), np.asarray(ids_part)
        with self._lock:
            fenced = sum(1 for w in group if w.fenced)
        raise ReplicaUnavailableError(
            f"shard {shard} of {self.name!r}: no worker could serve "
            f"(last: {last_exc!r})", name=f"{self.name}/s{shard}",
            replicas=len(group), fenced=fenced)

    def _search(self, queries, k: int, timeout_s, rid):
        q = np.asarray(queries, np.float32)
        expects(q.ndim == 2, "queries must be (rows, d); got ndim=%d",
                q.ndim)
        parts = list(self._pool.map(
            lambda s: self._scatter_one(s, q, k, timeout_s, rid),
            range(self.spec.n_shards)))
        # host-side candidates-only merge: ascending distances win
        dists = np.concatenate([p[0] for p in parts], axis=1)
        ids = np.concatenate([p[1] for p in parts], axis=1)
        k = min(int(k), dists.shape[1])
        sel = np.argpartition(dists, k - 1, axis=1)[:, :k]
        rows = np.arange(dists.shape[0])[:, None]
        dists, ids = dists[rows, sel], ids[rows, sel]
        order = np.argsort(dists, axis=1, kind="stable")
        return dists[rows, order], ids[rows, order]

    # -- the submit-shaped surface -------------------------------------------
    def submit(self, name: str, queries, k: int = 10, *,
               timeout_s: float | None = None,
               rid: str | None = None) -> Future:
        """Scatter-gather across the fleet; ``SearchService.submit``-shaped
        (refusals raise synchronously, success is a resolved Future), so
        the front door and ``submit_with_retry`` compose unchanged."""
        if self._closed:
            from ..serve.errors import ServiceClosedError

            raise ServiceClosedError("mesh is closed")
        if name != self.name:
            raise RaftError(f"no index published under {name!r} "
                            f"(this mesh serves {self.name!r})")
        fut: Future = Future()
        fut.set_result(self._search(queries, int(k), timeout_s, rid))
        return fut

    def search(self, name: str, queries, k: int = 10, *,
               timeout_s: float | None = None):
        return self.submit(name, queries, k, timeout_s=timeout_s).result()

    # -- write path ----------------------------------------------------------
    def _write_group(self, shard: int, apply) -> list:
        """Apply one write to every replica of a group; a replica that
        fails is STRUCK (it missed the write — it must not serve until it
        proves itself again) and the write succeeds as long as at least
        one twin took it. In this mesh the only replica failure mode is
        process death, which is permanent, so a struck-stale twin can
        never probe back in with missing rows; a mesh over transient
        transports would need a catch-up path before unfencing. Zero
        successes is an outage: :class:`ReplicaUnavailableError`."""
        results, last_exc = [], None
        for w in self._workers[shard]:
            try:
                results.append(apply(w))
            except RaftError as exc:
                if not isinstance(exc, ServeError):
                    raise  # validation: identical on every twin
                last_exc = exc
                self._strike(w, exc)
            except Exception as exc:  # noqa: BLE001 - connection-level
                last_exc = exc
                self._strike(w, exc)
        if not results:
            group = self._workers[shard]
            with self._lock:
                fenced = sum(1 for w in group if w.fenced)
            raise ReplicaUnavailableError(
                f"shard {shard} of {self.name!r}: no worker took the "
                f"write (last: {last_exc!r})", name=f"{self.name}/s{shard}",
                replicas=len(group), fenced=fenced)
        return results

    def upsert(self, name: str, rows, ids=None):
        """Route rows to their owning shard groups by the shared hash and
        apply to EVERY live replica (twins stay twins; see
        :meth:`_write_group` for the failed-twin rule). Global ids are
        required — workers must never mint (they would collide)."""
        from ..stream.sharded import shard_of

        expects(name == self.name, "this mesh serves %r", self.name)
        expects(ids is not None,
                "mesh upsert requires explicit global ids")
        rows = np.asarray(rows, np.float32)
        ids = np.asarray(ids, np.int64)
        owner = np.asarray(shard_of(ids, self.spec.n_shards))
        for s in range(self.spec.n_shards):
            mask = owner == s
            if mask.any():
                self._write_group(
                    s, lambda w, m=mask: w.client.upsert(
                        self.name, rows[m], ids[m]))
        return ids

    def delete(self, name: str, ids) -> int:
        from ..stream.sharded import shard_of

        expects(name == self.name, "this mesh serves %r", self.name)
        ids = np.asarray(ids, np.int64)
        owner = np.asarray(shard_of(ids, self.spec.n_shards))
        deleted = 0
        for s in range(self.spec.n_shards):
            mask = owner == s
            if mask.any():
                counts = self._write_group(
                    s, lambda w, m=mask: w.client.delete(self.name, ids[m]))
                deleted += counts[0]  # live twins report identically
        return deleted

    # -- introspection / chaos ----------------------------------------------
    def health(self) -> dict:
        """Shaped like the sharded replica-health payload, so the obs
        exporter's ``/healthz`` fold applies unchanged: a group at zero
        pickable workers is failing/503."""
        with self._lock:
            shards = []
            for s, group in enumerate(self._workers):
                reps = [{"name": w.label, "fenced": bool(w.fenced),
                         "alive": bool(w.proc.is_alive()),
                         "port": w.port} for w in group]
                shards.append({"shard": s, "replicas": reps,
                               "healthy": sum(1 for r in reps
                                              if not r["fenced"]
                                              and r["alive"])})
        return {"shards": shards}

    def stats(self) -> dict:
        """Fleet-summed worker stats — ``compile_s``/``cache_misses``
        across every live worker is the zero-kernel-build proof for the
        whole wire path (``boot_*`` the same for the workers' boots), and
        ``launches`` sums each worker's kernel launches since its window
        opened; ``per_worker`` keeps each live worker's own stats by label.
        Fenced/dead workers are skipped (and listed)."""
        total = {"compile_s": 0.0, "cache_misses": 0, "boot_compile_s": 0.0,
                 "boot_cache_misses": 0, "boot_cache_hits": 0,
                 "workers": 0, "unreachable": [], "launches": {},
                 "per_worker": {}}
        for group in self._workers:
            for w in group:
                try:
                    st = w.client.stats()
                except Exception:  # noqa: BLE001 - dead worker
                    total["unreachable"].append(w.label)
                    continue
                total["per_worker"][w.label] = st
                for key in ("compile_s", "boot_compile_s"):
                    total[key] += float(st.get(key, 0.0))
                for key in ("cache_misses", "boot_cache_misses",
                            "boot_cache_hits"):
                    total[key] += int(st.get(key, 0))
                for name, n in (st.get("launches") or {}).items():
                    total["launches"][name] = (total["launches"].get(name, 0)
                                               + int(n))
                total["workers"] += 1
        return total

    def kill_worker(self, shard: int = 0, replica: int = 0) -> int:
        """SIGKILL one worker process (chaos hook for tests/bench);
        returns its pid. The next scatter that picks it strikes, fences
        and fails over within the same call."""
        w = self._workers[shard][replica]
        pid = w.proc.pid
        w.proc.kill()
        # a worker with a CUDA context can take seconds to exit, and until
        # its files close its listening socket still accepts connections
        # that nobody answers: a scatter that picked it would wait out the
        # socket timeout instead of failing over, so wait for the exit
        w.proc.join(KILL_WAIT_S)
        expects(not w.proc.is_alive(), "worker %s outlived SIGKILL by %gs", w.label,
                KILL_WAIT_S)
        return pid

    def close(self) -> None:
        """Stop every worker (graceful via the pipe, kill stragglers)."""
        self._closed = True
        workers = [w for g in self._workers for w in g]
        for w in workers:
            try:
                w.conn.send("stop")
            except Exception:  # noqa: BLE001 - already dead
                pass
        for w in workers:
            w.proc.join(5.0)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(5.0)
            w.conn.close()
        if getattr(self, "_pool", None) is not None:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "ProcessMesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
