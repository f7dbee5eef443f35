"""decline-discipline: device paths bail to host ONLY through the
canonical decline signals, so the kernels ladder stays enumerable:

- `raise UnsupportedOnDevice("<reason>")` — the reason string is mandatory
  (a bare decline is invisible in logs and unanalyzable in bench output);
- the ops/kernels.py helpers: `decline(reason)` (raising form),
  `host_fallback(reason)` (Optional-sentinel form, logs + counts), and
  `step_aside(reason)` (mid-ladder: the next rung still gets tried).

Checks, scoped to ballista_tpu_torch/ops/ and ballista_tpu_torch/parallel/:

1. `raise UnsupportedOnDevice()` / `raise TooManyGroups()` with no reason
   (or an empty one) is flagged;
2. inside an `except UnsupportedOnDevice` (or TooManyGroups) handler, a
   bare `return None` silently converts a reasoned decline into an
   anonymous host fallback — return `host_fallback(<reason>)` instead. A
   handler that counts its decline itself is not silent: it records the
   host route (`record_routing("host", ...)`) and the caught exception's
   reason through a routing recorder (`record_routing_reason`,
   `record_join_path`, `record_route`, `record_step_aside`,
   `record_decline_trace`). The mesh aggregate and the mesh join
   (parallel/spmd_stage.py, spmd_join.py) answer on the host that way and
   then end their generator;
3. ad-hoc `raise Exception/RuntimeError/NotImplementedError` is not a
   decline channel (callers catch UnsupportedOnDevice; anything else
   either crashes the query or is swallowed by a broad fallback handler
   that then logs it as a real error). A failure that must propagate (a
   kernel that does not build or launch, a device the caller named that
   is missing) raises the typed `errors.DeviceError`."""

from __future__ import annotations

import ast
from typing import List

from ballista_tpu_torch.analysis.common import final_name, is_device_path
from ballista_tpu_torch.analysis.core import Finding, SourceFile, register

_DECLINE_TYPES = {"UnsupportedOnDevice", "TooManyGroups"}
_ADHOC_TYPES = {"Exception", "RuntimeError", "NotImplementedError"}
# recorders that count a decline's reason
_REASON_RECORDERS = {
    "record_routing_reason", "record_join_path", "record_route",
    "record_step_aside", "record_decline_trace",
}


def _handler_catches_decline(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return False
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    return any(final_name(x) in _DECLINE_TYPES for x in types)


def _handler_counts_decline(handler: ast.ExceptHandler) -> bool:
    """The handler records the host route and the caught reason."""
    host_route = False
    reason = False
    for node in ast.walk(handler):
        if not isinstance(node, ast.Call):
            continue
        name = final_name(node.func)
        if name == "record_routing" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value == "host":
            host_route = True
        elif name in _REASON_RECORDERS and handler.name:
            args = list(node.args) + [k.value for k in node.keywords]
            if any(isinstance(n, ast.Name) and n.id == handler.name
                   for a in args for n in ast.walk(a)):
                reason = True
    return host_route and reason


@register("decline-discipline")
def check(sf: SourceFile) -> List[Finding]:
    if not is_device_path(sf.path):
        return []
    findings: List[Finding] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call):
            name = final_name(node.exc.func)
            if name in _DECLINE_TYPES:
                args = node.exc.args
                empty = not args or (
                    isinstance(args[0], ast.Constant)
                    and not str(args[0].value).strip()
                )
                if empty:
                    findings.append(Finding(
                        "decline-discipline", sf.path, node.lineno,
                        node.col_offset,
                        f"{name} raised without a reason — every decline "
                        "must say why (the ladder must stay enumerable)",
                    ))
            elif name in _ADHOC_TYPES:
                findings.append(Finding(
                    "decline-discipline", sf.path, node.lineno,
                    node.col_offset,
                    f"ad-hoc `raise {name}` in a device-path module — "
                    "decline with UnsupportedOnDevice(reason) / "
                    "kernels.decline(reason), or raise a specific typed "
                    "error (errors.DeviceError for a failure that must "
                    "not fall back)",
                ))
        elif isinstance(node, ast.ExceptHandler) \
                and _handler_catches_decline(node) \
                and not _handler_counts_decline(node):
            for inner in ast.walk(node):
                if isinstance(inner, ast.Return):
                    v = inner.value
                    is_none = v is None or (
                        isinstance(v, ast.Constant) and v.value is None
                    )
                    if is_none:
                        findings.append(Finding(
                            "decline-discipline", sf.path, inner.lineno,
                            inner.col_offset,
                            "silent `return None` inside an "
                            "UnsupportedOnDevice handler — return "
                            "kernels.host_fallback(reason), or record "
                            "record_routing(\"host\", ...) and the caught "
                            "reason, so the decline is logged and counted",
                        ))
    return findings
