"""The port's single-process engine: one `ExecutionContext` on one card,
driven through `ctx.sql(q).collect()` by one closed-loop stream."""

from __future__ import annotations

import gc
import os
import time

from perfbench.tpch.schema import TPCH_TABLES


class Engine:
    def __init__(self, cfg: dict, data_dir: str, device: str, streams: int) -> None:
        if streams != 1:
            raise ValueError(f"the local engine runs one stream, not {streams}")
        from ballista_tpu_torch.config import BallistaConfig
        from ballista_tpu_torch.engine import ExecutionContext

        self.device = device
        self.ctx = ExecutionContext(BallistaConfig(dict(cfg["settings"])), device=device)
        for t in TPCH_TABLES:
            self.ctx.register_parquet(t, os.path.join(data_dir, t))

    def _sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    def run(self, q):
        out = self.ctx.sql(q.sql).collect()
        self._sync()
        return out

    def counters(self) -> dict:
        from perfbench.counters import engine_counters

        return engine_counters(serving=False)

    def window(self, streams: list, seconds: float) -> tuple:
        """(start, records) of a window of `seconds`: the stream issues its
        queries in order until the deadline; the query in flight then
        finishes. Each record also carries the planning time: ctx.sql
        (parse and logical plan) and the program's own `plan` span
        (optimize and physical plan), which opens collect()."""
        from ballista_tpu_torch.utils import tracing

        start = time.perf_counter()
        records: list = []
        for q in streams[0]:
            t0 = time.perf_counter()
            if t0 >= start + seconds:
                break
            seen = len(tracing.spans())
            rec = {"stream": 0, "query": q, "t0": t0, "ok": False, "answer": None,
                   "error": None}
            try:
                df = self.ctx.sql(q.sql)
                t_sql = time.perf_counter()
                rec["answer"] = df.collect()
                self._sync()
                rec["ok"] = True
            except Exception as e:  # a failed query is counted, not fatal
                rec["error"] = repr(e)
                t_sql = t0
            rec["t1"] = time.perf_counter()
            plan = next((dt for path, dt, _ in tracing.spans()[seen:] if path == "plan"), 0.0)
            if rec["ok"]:
                rec["plan_s"] = (t_sql - t0) + plan
            rec["spans"] = [("sql", t0, t_sql), ("plan", t_sql, t_sql + plan),
                            ("execute", t_sql + plan, rec["t1"])]
            records.append(rec)
        return start, records

    def close(self) -> None:
        """Free the program's state: the context, its resident stages and
        the card's cached blocks."""
        from ballista_tpu_torch.ops import kernels

        self.ctx = None
        kernels.clear_stage_cache()
        gc.collect()
        if self.device != "cpu":
            import torch

            torch.cuda.empty_cache()
