"""The device trace of a `--trace 1` window: torch.profiler over the
window, recording the card's activity only, read from its raw events (no
per-op tree is built). Device time is the union of every kernel, copy
and memset on the card; an idle gap is named by the harness span the host
was in at its middle (an engine's records carry their spans: `sql`,
`plan`, `execute` in the local engine, `query` while a client waits on the
cluster), and `harness` outside every span.

The profiler's clock is tied to time.perf_counter by a marker: a short
kernel launched once the card is idle, right after the host reads its
clock; it is the trace's first device event."""

from __future__ import annotations

import collections
import time

import numpy as np

from perfbench.stats import idle_stretches

TOP = 10


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


class DeviceTrace:
    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()  # the CPU tests trace no device
        if self.cuda:
            torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                        else ProfilerActivity.CPU])
        self.prof.__enter__()
        self.mark_ns = time.perf_counter_ns()
        if self.cuda:
            torch.cuda.synchronize()
            self.mark_ns = time.perf_counter_ns()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def summary(self, start: float, end: float, records: list) -> dict:
        """busy_s and the breakdown over [start, end] (perf_counter s)."""
        from torch.autograd import DeviceType

        names, starts, ends = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                a = _ns(e, "start")
                names.append(e.name())
                starts.append(a)
                ends.append(_ns(e, "end") if hasattr(e, "end_ns") else a + _ns(e, "duration"))
        a, b = np.asarray(starts, dtype=np.int64), np.asarray(ends, dtype=np.int64)
        offset = int(a.min()) - self.mark_ns if len(a) else 0  # profiler - perf_counter
        lo, hi = int(start * 1e9) + offset, int(end * 1e9) + offset
        a, b = np.clip(a, lo, hi), np.clip(b, lo, hi)
        keep = b > a
        per_op = collections.Counter()
        for n, d in zip(np.asarray(names, dtype=object)[keep], (b - a)[keep]):
            per_op[n] += d / 1e9
        g0, g1 = idle_stretches(a[keep], b[keep], lo, hi)
        busy = (hi - lo) - int((g1 - g0).sum())
        host = sorted((t0, t1, n) for r in records for n, t0, t1 in r["spans"])
        h0 = np.asarray([h[0] for h in host])
        mids = ((g0 + g1) / 2 - offset) / 1e9
        at = np.searchsorted(h0, mids, side="right")

        def span_name(i: int, mid: float) -> str:
            # spans of one stream never overlap: a few streams' last spans
            return next((n for t0, t1, n in reversed(host[max(0, i - 8):i]) if mid < t1),
                        "harness")

        lengths = (g1 - g0) / 1e9
        by_name = collections.Counter()
        for i, mid, s in zip(at, mids, lengths):
            by_name[span_name(int(i), float(mid))] += float(s)
        top = np.argsort(-lengths, kind="stable")[:TOP]
        return {
            "busy_s": busy / 1e9,
            "window_s": end - start,
            "device_ops": [[n, s] for n, s in per_op.most_common(TOP)],
            "idle_gaps": [[span_name(int(at[i]), float(mids[i])), float(lengths[i])]
                          for i in top],
            "idle_by_span": dict(by_name),
            "events": int(keep.sum()),
        }
