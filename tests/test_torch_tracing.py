"""The port's device span (ballista_tpu_torch/utils/tracing.py): with
BALLISTA_TRACE_DIR set, span(name, device=True) runs its body under
torch.profiler and leaves one Chrome trace in that directory, here on the
CPU (on the card the trace also names the CUDA kernels, chip_smoke.py phase
11). Without the variable, or without device=True, a span only times."""

import json

import torch

from ballista_tpu_torch.utils import tracing


def test_device_span_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("BALLISTA_TRACE_DIR", str(tmp_path / "traces"))
    with tracing.span("stage/run", device=True):
        (torch.arange(4096, dtype=torch.float32) * 2).sum()
    files = list((tmp_path / "traces").iterdir())
    assert len(files) == 1 and files[0].name.startswith("stage_run-")
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert tracing.spans()[-1][0].endswith("stage/run")


def test_span_without_device_or_directory_only_times(tmp_path, monkeypatch):
    monkeypatch.delenv("BALLISTA_TRACE_DIR", raising=False)
    with tracing.span("plain", device=True):
        pass
    monkeypatch.setenv("BALLISTA_TRACE_DIR", str(tmp_path / "traces"))
    with tracing.span("host only"):
        pass
    assert not (tmp_path / "traces").exists()
    assert [p for p, _dt, _d in tracing.spans()][-2:] == ["plain", "host only"]
