"""The port's in-process cluster: `StandaloneCluster` (one scheduler and
`executors` executors, all on one card, in this process), with each stream
a client process of its own that drives `BallistaContext.sql(q).collect()`
(the pattern of ballista_tpu_torch/bench/scenarios/latency.py::_client_proc
at commit aab2caf, copied). The clients are started in set-up; they hold no
device work (their contexts are on the CPU: the executors run every
stage), so the card has one process."""

from __future__ import annotations

import gc
import multiprocessing as mp
import os
import queue
import time

from perfbench.tpch.schema import TPCH_TABLES

# seconds a client may take to connect and register, and past the window's
# close to finish the query in flight and hand back its records
READY_S = 120.0
DRAIN_S = 300.0


def _context(host: str, port: int, settings: dict, data_dir: str):
    from ballista_tpu_torch.client import BallistaContext

    ctx = BallistaContext(host, port, settings=settings, device="cpu")
    for t in TPCH_TABLES:
        ctx.register_parquet(t, os.path.join(data_dir, t))
    return ctx


def _client(idx: int, host: str, port: int, settings: dict, data_dir: str,
            inbox, outbox) -> None:
    """One closed-loop client process: connect, say ready, wait for the
    window's queries, run them in order until the deadline, and hand back
    one record per query (answer included)."""
    try:
        ctx = _context(host, port, settings, data_dir)
    except Exception as e:
        outbox.put(("error", idx, repr(e)))
        return
    outbox.put(("ready", idx, None))
    job = inbox.get()
    if job is None:
        ctx.close()
        return
    queries, start, deadline = job
    while time.perf_counter() < start:
        time.sleep(min(0.01, max(0.0, start - time.perf_counter())))
    records = []
    for q in queries:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        rec = {"stream": idx, "query": q, "t0": t0, "ok": False, "answer": None,
               "error": None}
        try:
            rec["answer"] = ctx.sql(q.sql).collect()
            rec["ok"] = True
        except Exception as e:  # a failed query is counted, not fatal
            rec["error"] = repr(e)
        rec["t1"] = time.perf_counter()
        rec["spans"] = [("query", t0, rec["t1"])]
        records.append(rec)
    outbox.put(("records", idx, records))
    ctx.close()


class Engine:
    def __init__(self, cfg: dict, data_dir: str, device: str, streams: int) -> None:
        from ballista_tpu_torch.config import BallistaConfig
        from ballista_tpu_torch.executor.runtime import StandaloneCluster

        settings = dict(cfg["settings"])
        self.n_clients = streams
        self.cluster = StandaloneCluster(n_executors=int(cfg["executors"]), device=device,
                                         config=BallistaConfig(settings))
        host, port = self.cluster.scheduler_addr
        self.ctx = _context(host, port, settings, data_dir)
        spawn = mp.get_context("spawn")  # never fork a process running grpc or CUDA
        self.outbox = spawn.Queue()
        self.inboxes = [spawn.Queue() for _ in range(self.n_clients)]
        self.procs = [spawn.Process(target=_client, daemon=True,
                                    args=(i, host, port, settings, data_dir,
                                          self.inboxes[i], self.outbox))
                      for i in range(self.n_clients)]
        for p in self.procs:
            p.start()
        for _ in self.procs:
            tag, idx, err = self.outbox.get(timeout=READY_S)
            if tag != "ready":
                raise RuntimeError(f"client {idx} failed to start: {err}")

    def run(self, q):
        return self.ctx.sql(q.sql).collect()

    def counters(self) -> dict:
        from perfbench.counters import engine_counters

        return engine_counters(serving=True)

    def window(self, streams: list, seconds: float) -> tuple:
        """(start, records): stream i goes to client i; each issues its
        queries until the deadline and finishes the one in flight."""
        if len(streams) != self.n_clients:
            raise ValueError(f"{len(streams)} streams for {self.n_clients} clients")
        start = time.perf_counter() + 0.05
        for inbox, qs in zip(self.inboxes, streams):
            inbox.put((qs, start, start + seconds))
        records, errors = [], []
        end = start + seconds + DRAIN_S
        for _ in self.procs:
            try:
                tag, idx, body = self.outbox.get(timeout=max(1.0, end - time.perf_counter()))
            except queue.Empty:
                errors.append("a client handed back no records")
                break
            if tag == "records":
                records += body
            else:
                errors.append(f"client {idx}: {body}")
        if errors:
            raise RuntimeError("; ".join(errors))
        return start, records

    def close(self) -> None:
        """Stop the clients and the cluster, and wait for each."""
        for inbox, p in zip(self.inboxes, self.procs):
            if p.is_alive():
                inbox.put(None)
        for p in self.procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
                p.join(10)
        self.ctx.close()
        self.cluster.shutdown()
        self.ctx = self.cluster = None
        from ballista_tpu_torch.ops import kernels

        kernels.clear_stage_cache()
        gc.collect()
        import torch

        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
