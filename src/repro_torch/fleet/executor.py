"""Pod executors: the serial reference and the process-parallel engine.

Both present the same interface to the fleet driver — snapshots / feeds /
drains / evacuations / a barrier-synchronized ``advance_all`` — and both
return results in **pod-id submission order**, so the driver's view of the
fleet is byte-identical whichever executor runs underneath:

* :class:`SerialExecutor` owns every :class:`~repro.fleet.pod.PodHost`
  in-process and advances them one after another (the reference).
* :class:`ParallelExecutor` forks ``workers`` persistent processes, pins
  pods to workers round-robin, and drives them over pipes.  Pods are
  share-nothing between barriers, every host is built from the same
  picklable recipe, and all cross-pod state (router, switch) lives in the
  driver process — so the only difference is which OS process executes a
  pod's (deterministic) event loop, and per-pod trajectories match the
  serial executor bit for bit.

``advance_all`` is the parallel section: one command per worker, each
worker advancing its pods back-to-back, the driver blocking until every
worker acks — the bounded-lag window barrier.
"""
from __future__ import annotations

import multiprocessing as mp
from typing import Dict, List, Sequence, Tuple

from ..sched.cluster import ClusterMetrics
from ..sched.events import TenantSpec
from .pod import FleetPodParams, PodHost, PodSpec
from .router import PodView


class SerialExecutor:
    """All pods in the driver process, advanced in pod order."""

    workers = 1

    def __init__(self, pod_specs: Sequence[PodSpec],
                 params: FleetPodParams):
        self.order = [ps.pod_id for ps in pod_specs]
        self._hosts: Dict[int, PodHost] = {
            ps.pod_id: PodHost(ps, params) for ps in pod_specs}

    def snapshots(self) -> List[PodView]:
        return [self._hosts[pid].snapshot() for pid in self.order]

    def feed_many(self, batches: Dict[int, List[TenantSpec]]) -> None:
        for pid in sorted(batches):
            self._hosts[pid].feed(batches[pid])

    def advance_all(self, t: float) -> None:
        for pid in self.order:
            self._hosts[pid].advance_to(t)

    def drain(self, pod_id: int) -> None:
        self._hosts[pod_id].drain()

    def undrain(self, pod_id: int) -> None:
        self._hosts[pod_id].undrain()

    def fail(self, pod_id: int) -> None:
        self._hosts[pod_id].fail()

    def evacuate(self, pod_id: int, now: float
                 ) -> Tuple[List[TenantSpec], List[TenantSpec]]:
        return self._hosts[pod_id].evacuate(now)

    def drain_traces(self) -> List[Tuple[int, dict]]:
        return [(pid, self._hosts[pid].drain_trace()) for pid in self.order]

    def finish_all(self) -> List[ClusterMetrics]:
        return [self._hosts[pid].finish() for pid in self.order]

    def close(self) -> None:
        self._hosts.clear()


def _worker_main(conn, pod_specs: List[PodSpec],
                 params: FleetPodParams) -> None:
    """One worker process: build the pinned hosts, serve commands until
    ``close``.  Any exception is shipped back as ``("err", repr)`` so the
    driver fails loudly instead of deadlocking on a dead pipe."""
    hosts = {ps.pod_id: PodHost(ps, params)
             for ps in sorted(pod_specs, key=lambda p: p.pod_id)}
    order = sorted(hosts)
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            break
        cmd, args = msg[0], msg[1:]
        try:
            if cmd == "snapshots":
                out = [hosts[pid].snapshot() for pid in order]
            elif cmd == "feed_many":
                for pid, specs in args[0]:
                    hosts[pid].feed(specs)
                out = None
            elif cmd == "advance_all":
                for pid in order:
                    hosts[pid].advance_to(args[0])
                out = None
            elif cmd in ("drain", "undrain", "fail"):
                getattr(hosts[args[0]], cmd)()
                out = None
            elif cmd == "evacuate":
                out = hosts[args[0]].evacuate(args[1])
            elif cmd == "drain_traces":
                out = [(pid, hosts[pid].drain_trace()) for pid in order]
            elif cmd == "finish_all":
                out = [(pid, hosts[pid].finish()) for pid in order]
            elif cmd == "close":
                conn.send(("ok", None))
                break
            else:
                raise ValueError(f"unknown executor command {cmd!r}")
            conn.send(("ok", out))
        except Exception as exc:                     # pragma: no cover
            import traceback
            conn.send(("err", f"{exc!r}\n{traceback.format_exc()}"))
    conn.close()


class ParallelExecutor:
    """``workers`` forked processes, pods pinned round-robin.

    Fork keeps startup cheap (the parent's imports are inherited) and is
    the start method this codebase's numpy state tolerates — hosts are
    still built *inside* the workers from picklable recipes, never
    shipped across, so the fork point carries no pod state.
    """

    def __init__(self, pod_specs: Sequence[PodSpec],
                 params: FleetPodParams, workers: int):
        if workers < 2:
            raise ValueError("ParallelExecutor needs workers >= 2 "
                             "(use SerialExecutor for workers=1)")
        self.order = [ps.pod_id for ps in pod_specs]
        self.workers = min(workers, len(pod_specs))
        ctx = mp.get_context("fork")
        assign: List[List[PodSpec]] = [[] for _ in range(self.workers)]
        self._owner: Dict[int, int] = {}
        for i, ps in enumerate(pod_specs):
            assign[i % self.workers].append(ps)
            self._owner[ps.pod_id] = i % self.workers
        self._procs = []
        self._conns = []
        for w in range(self.workers):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_worker_main,
                               args=(child, assign[w], params), daemon=True)
            proc.start()
            child.close()
            self._procs.append(proc)
            self._conns.append(parent)

    # -- plumbing ----------------------------------------------------------
    @staticmethod
    def _recv(conn):
        status, payload = conn.recv()
        if status != "ok":
            raise RuntimeError(f"fleet worker failed:\n{payload}")
        return payload

    def _call_all(self, *msg) -> List:
        """Fan a command out to every worker, then collect every ack —
        the workers run the command concurrently."""
        for conn in self._conns:
            conn.send(msg)
        return [self._recv(conn) for conn in self._conns]

    def _call_owner(self, pod_id: int, *msg):
        conn = self._conns[self._owner[pod_id]]
        conn.send(msg)
        return self._recv(conn)

    # -- interface ---------------------------------------------------------
    def snapshots(self) -> List[PodView]:
        views: Dict[int, PodView] = {}
        for worker_views in self._call_all("snapshots"):
            for v in worker_views:
                views[v.pod_id] = v
        return [views[pid] for pid in self.order]

    def feed_many(self, batches: Dict[int, List[TenantSpec]]) -> None:
        per_worker: List[List[Tuple[int, List[TenantSpec]]]] = [
            [] for _ in range(self.workers)]
        for pid in sorted(batches):
            per_worker[self._owner[pid]].append((pid, batches[pid]))
        for w, items in enumerate(per_worker):
            if items:
                self._conns[w].send(("feed_many", items))
        for w, items in enumerate(per_worker):
            if items:
                self._recv(self._conns[w])

    def advance_all(self, t: float) -> None:
        self._call_all("advance_all", t)

    def drain(self, pod_id: int) -> None:
        self._call_owner(pod_id, "drain", pod_id)

    def undrain(self, pod_id: int) -> None:
        self._call_owner(pod_id, "undrain", pod_id)

    def fail(self, pod_id: int) -> None:
        self._call_owner(pod_id, "fail", pod_id)

    def evacuate(self, pod_id: int, now: float
                 ) -> Tuple[List[TenantSpec], List[TenantSpec]]:
        return self._call_owner(pod_id, "evacuate", pod_id, now)

    def drain_traces(self) -> List[Tuple[int, dict]]:
        payloads: Dict[int, dict] = {}
        for worker_out in self._call_all("drain_traces"):
            for pid, payload in worker_out:
                payloads[pid] = payload
        return [(pid, payloads[pid]) for pid in self.order]

    def finish_all(self) -> List[ClusterMetrics]:
        metrics: Dict[int, ClusterMetrics] = {}
        for worker_out in self._call_all("finish_all"):
            for pid, m in worker_out:
                metrics[pid] = m
        return [metrics[pid] for pid in self.order]

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(("close",))
                conn.recv()
            except (BrokenPipeError, EOFError):
                pass
            conn.close()
        for proc in self._procs:
            proc.join(timeout=10)
            if proc.is_alive():                      # pragma: no cover
                proc.terminate()


def make_executor(pod_specs: Sequence[PodSpec], params: FleetPodParams,
                  workers: int):
    """workers=1 -> the serial reference; >1 -> the forked engine."""
    if workers <= 1:
        return SerialExecutor(pod_specs, params)
    return ParallelExecutor(pod_specs, params, workers)
