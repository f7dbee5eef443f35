"""The control of the comparison that decides `correct` (PERF.md §2): the
plain reference put in the program's place and computed in float32, the
precision below the float64 that the configurations state. A run with it
must come out not correct.

    python -m perfbench.control --workload <cell> --seed <n> --seconds <s>

runs the cell as a run does (the database from the seed, its traffic and
window) with `ControlEngine` in place of the port, and prints the numbers
compared, each beside its limit. It needs no card: the control is NumPy."""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import pyarrow as pa

from perfbench import catalog
from perfbench.reference.tables import Tables


def to_table(answer: dict, limit) -> pa.Table:
    """A reference answer as the program would return it: floats widened
    to float64, the first `limit` rows."""
    t = pa.table({c: v if isinstance(v, list) else
                  np.asarray(v, dtype=np.float64 if v.dtype.kind == "f" else np.int64)
                  for c, v in answer.items()})
    return t if limit is None else t.slice(0, limit)


class ControlEngine:
    """Answers every query with the reference in float32, each distinct
    query once; the streams take turns, one query each."""

    def __init__(self, cfg: dict, data_dir: str, device: str, streams: int) -> None:
        self.tables = Tables(data_dir, np.float32)
        self.answers: dict = {}

    def run(self, q):
        if q not in self.answers:
            ref = catalog.module("reference", q.template)
            self.answers[q] = to_table(ref.answer(self.tables, dict(q.params)), ref.LIMIT)
        return self.answers[q]

    def counters(self) -> dict:
        return {}

    def window(self, streams: list, seconds: float) -> tuple:
        start = time.perf_counter()
        records = []
        for j in range(max(len(s) for s in streams)):
            for i, qs in enumerate(streams):
                if j >= len(qs):
                    continue
                t0 = time.perf_counter()
                if t0 >= start + seconds:
                    return start, records
                answer = self.run(qs[j])
                t1 = time.perf_counter()
                records.append({"stream": i, "query": qs[j], "t0": t0, "t1": t1, "ok": True,
                                "answer": answer, "error": None,
                                "spans": [("query", t0, t1)]})
        return start, records

    def close(self) -> None:
        self.answers.clear()


def main(argv=None) -> int:
    from perfbench.run import run_cell

    ap = argparse.ArgumentParser(prog="python -m perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    result = run_cell(a.workload, a.seed, a.seconds, False, "cpu", time.perf_counter(),
                      engine_cls=ControlEngine)
    print(json.dumps({"correct": result["correct"], "attempted": result["attempted"],
                      "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
