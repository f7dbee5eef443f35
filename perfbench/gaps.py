"""python -m perfbench.gaps --workload <cell> --seed <n> --seconds <s>

A `--trace 1` run of one cell (perfbench/run.py) whose device idle gaps
are also labelled by the program's own spans: `<harness span>:<innermost
program span>`, the program span being the one open at the gap's middle
that started last (perfbench/spans.py; a bare harness label where none is
open or the program records none). Prints, as the last line of standard
output, one JSON object: the run's own result line under `result`, the ten
longest gaps so labelled, the idle seconds by label, the shares of the
idle time and of the ten longest gaps that fall under a program span other
than the bare `execute`, `plan` or `sql`, and each span's self and total
ms per completed query, overall and by template. The run's own metrics and
breakdown are those of `python -m perfbench --trace 1`."""

from __future__ import annotations

import argparse
import collections
import heapq
import json
import sys
import time

import numpy as np

from perfbench import run as bench
from perfbench import spans as program_spans
from perfbench import trace
from perfbench.stats import idle_stretches

BARE = ("execute", "plan", "sql")


def label_gaps(g0, g1, harness: list, spans: list) -> list:
    """`<harness>:<program>` of each gap [g0, g1) (perf_counter ns, sorted
    by start): the harness span (name, t0, t1 in s) and the program span
    open at the middle that started last."""
    mids = (np.asarray(g0, dtype=np.int64) + np.asarray(g1, dtype=np.int64)) // 2
    order = np.argsort(mids, kind="stable")
    by_start = sorted(spans, key=lambda r: r.start_ns)
    host = sorted((int(t0 * 1e9), int(t1 * 1e9), n) for n, t0, t1 in harness)
    labels = [""] * len(mids)
    open_spans: list = []  # heap of (-start, i)
    open_host: list = []
    i = j = 0
    for k in order:
        m = int(mids[k])
        while i < len(by_start) and by_start[i].start_ns <= m:
            heapq.heappush(open_spans, (-by_start[i].start_ns, i))
            i += 1
        while j < len(host) and host[j][0] <= m:
            heapq.heappush(open_host, (-host[j][0], j))
            j += 1
        while open_spans and by_start[open_spans[0][1]].end_ns <= m:
            heapq.heappop(open_spans)
        while open_host and host[open_host[0][1]][1] <= m:
            heapq.heappop(open_host)
        outer = host[open_host[0][1]][2] if open_host else "harness"
        inner = by_start[open_spans[0][1]].name if open_spans else None
        labels[k] = f"{outer}:{inner}" if inner and inner != outer else outer
    return labels


def _under_program_span(label: str) -> bool:
    """A program span other than the bare `execute`, `plan` or `sql`
    follows the harness label."""
    return ":" in label and label.split(":", 1)[1] not in BARE


class LabelledTrace(trace.DeviceTrace):
    """DeviceTrace whose summary also keeps the gaps labelled by program
    span (the gaps as trace.DeviceTrace.summary finds them)."""

    last = None

    def __enter__(self):
        LabelledTrace.last = self
        return super().__enter__()

    def summary(self, start: float, end: float, records: list) -> dict:
        from torch.autograd import DeviceType

        out = super().summary(start, end, records)
        starts, ends = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                a = trace._ns(e, "start")
                starts.append(a)
                ends.append(trace._ns(e, "end") if hasattr(e, "end_ns")
                            else a + trace._ns(e, "duration"))
        a, b = np.asarray(starts, dtype=np.int64), np.asarray(ends, dtype=np.int64)
        offset = int(a.min()) - self.mark_ns if len(a) else 0
        lo, hi = int(start * 1e9) + offset, int(end * 1e9) + offset
        a, b = np.clip(a, lo, hi), np.clip(b, lo, hi)
        keep = b > a
        g0, g1 = idle_stretches(a[keep], b[keep], lo, hi)
        g0, g1 = g0 - offset, g1 - offset  # perf_counter ns
        spans = program_spans.window({"records": records}) or []
        labels = label_gaps(g0, g1, [s for r in records for s in r["spans"]], spans)
        lengths = (g1 - g0) / 1e9
        by_label = collections.Counter()
        for lab, s in zip(labels, lengths):
            by_label[lab] += float(s)
        top = np.argsort(-lengths, kind="stable")[:trace.TOP]
        idle = float(lengths.sum())
        under = sum(s for lab, s in by_label.items() if _under_program_span(lab))
        self.labelled = {
            "idle_gaps": [[labels[i], float(lengths[i])] for i in top],
            "idle_by_label": dict(by_label.most_common()),
            "idle_s": idle,
            "program_share": under / idle if idle else None,
            "top_with_program_span": sum(_under_program_span(labels[i]) for i in top),
            "program_spans": len(spans),
            **self_times(records, spans),
        }
        return out


def self_times(records: list, spans: list) -> dict:
    """Self and total ms of each span name per completed query
    (`per_query_ms`: [self, total]), and each template's mean self ms per
    completed run by span name (`by_template`), a span going to the query
    whose [t0, t1] holds its start."""
    ok = sorted((int(r["t0"] * 1e9), int(r["t1"] * 1e9), r["query"].template)
                for r in records if r["ok"])
    n = len(ok)
    runs = collections.Counter(t for _a, _b, t in ok)
    starts = [a for a, _b, _t in ok]
    per = collections.defaultdict(lambda: [0.0, 0.0])
    by = collections.defaultdict(collections.Counter)
    for r in spans:
        per[r.name][0] += r.self_ns / 1e6
        per[r.name][1] += (r.end_ns - r.start_ns) / 1e6
        i = int(np.searchsorted(starts, r.start_ns, side="right")) - 1
        if i >= 0 and r.start_ns <= ok[i][1]:
            by[ok[i][2]][r.name] += r.self_ns / 1e6
    return {
        "per_query_ms": {k: [v[0] / n, v[1] / n] for k, v in sorted(per.items())} if n else {},
        "by_template": {t: {k: v / runs[t] for k, v in c.most_common()} for t, c in by.items()},
    }


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python -m perfbench.gaps")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    bench.set_environment()
    import torch

    if not torch.cuda.is_available():
        bench.log("needs a CUDA device")
        return 2
    trace.DeviceTrace = LabelledTrace  # run_cell imports it at each run
    result = bench.run_cell(a.workload, a.seed, a.seconds, True, "cuda", t_start)
    labelled = getattr(LabelledTrace.last, "labelled", None)
    print(json.dumps({"result": result, "labelled": labelled}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
