"""readback-discipline: device->host materializations in
ballista_tpu_torch/ops/ and ballista_tpu_torch/parallel/ must pair with
record_readback (or go through the runtime.readback helper) in the same
function — otherwise readback_stats() undercounts, the O(limit)-readback
claim of the fused top-k goes unmeasured, and a host branch on a device
value is a hidden synchronization nobody counted.

A value is device-valued when it comes from a `torch.*` call (not the
host-side `torch.cuda.*`, `torch.device`, `torch.finfo`, ... families),
from `runtime.upload`, from a kernel wrapper (`sorted_grouped_sum`,
`grouped_aggregate`) or from a device step or program (names ending in
`_step`, `_core` or `_program`), or is derived from one; its metadata
(`.shape`, `.numel()`, `.dtype`, `.device`, ...) is host data. A
materialization is `.cpu()`, `.numpy()`, `.item()`, `.tolist()`,
`np.asarray(...)`, or `bool()`/`int()`/`float()` of a device value. Calls
on numpy arrays are not flagged."""

from __future__ import annotations

import ast
import re
from typing import List

from ballista_tpu_torch.analysis.common import (
    Taint,
    dotted,
    final_name,
    is_device_path,
    iter_functions,
    walk_no_nested_defs,
)
from ballista_tpu_torch.analysis.core import Finding, SourceFile, register

RULE = "readback-discipline"

# torch.* calls whose results live on the host
_HOST_TORCH = (
    "torch.cuda.", "torch.backends.", "torch.distributed.", "torch.profiler.",
    "torch.version", "torch.device", "torch.finfo", "torch.iinfo",
    "torch.get_", "torch.set_", "torch.is_", "torch.manual_seed",
    "torch.Size", "torch.Generator",
)
# device steps, programs and kernel wrappers (the port's naming)
_DEVICE_FN_RE = re.compile(
    r"(^upload$|_step$|_core$|^program$|_program$"
    r"|^sorted_grouped_sum$|^grouped_aggregate$)"
)
# tensor metadata: host values even on a device tensor
_META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "nbytes",
               "itemsize", "layout", "requires_grad"}
_META_CALLS = {"numel", "size", "dim", "element_size", "stride",
               "data_ptr", "is_contiguous", "nelement", "get_device"}
_MATERIALIZE_METHODS = {"cpu", "numpy", "item", "tolist"}
_MATERIALIZE_FNS = {"np.asarray", "numpy.asarray", "np.array", "numpy.array"}
_CASTS = {"bool", "int", "float"}
_RECORDERS = {"record_readback", "readback"}


def _is_source(call: ast.Call) -> bool:
    name = dotted(call.func)
    if name is not None and name.startswith("torch."):
        return not name.startswith(_HOST_TORCH)
    fin = final_name(call.func)
    return bool(fin and _DEVICE_FN_RE.search(fin))


class _DeviceTaint(Taint):
    """Taint whose seeds are device-valued calls and which stops at
    tensor metadata (`x.shape[0]` of a device tensor is a host int)."""

    def expr_tainted(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Attribute) and expr.attr in _META_ATTRS:
            return False
        if isinstance(expr, ast.Call):
            if isinstance(expr.func, ast.Attribute) \
                    and expr.func.attr in _META_CALLS:
                return False
            if self.call_tainted(expr):
                return True
        if isinstance(expr, ast.Name):
            return expr.id in self.names
        if isinstance(expr, (ast.Lambda, ast.FunctionDef)):
            return False
        return any(self.expr_tainted(c) for c in ast.iter_child_nodes(expr))


def _site_target(node: ast.Call):
    """The expression a materializing call reads back, or None."""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in _MATERIALIZE_METHODS:
        return f.value
    name = dotted(f)
    if name in _MATERIALIZE_FNS and node.args:
        return node.args[0]
    if name in _CASTS and len(node.args) == 1:
        return node.args[0]
    return None


@register(RULE)
def check(sf: SourceFile) -> List[Finding]:
    if not is_device_path(sf.path):
        return []
    findings: List[Finding] = []
    for func, _cls in iter_functions(sf.tree):
        taint = _DeviceTaint(func, lambda call, t: _is_source(call))
        sites = []
        records = False
        for node in walk_no_nested_defs(func):
            if not isinstance(node, ast.Call):
                continue
            if final_name(node.func) in _RECORDERS:
                records = True
                continue
            target = _site_target(node)
            if target is not None and taint.expr_tainted(target):
                sites.append(node)
        if sites and not records:
            for s in sites:
                findings.append(Finding(
                    RULE, sf.path, s.lineno, s.col_offset,
                    "device tensor materialized on the host without "
                    f"record_readback in '{func.name}' — route it through "
                    "ops.runtime.readback() or call record_readback(rows, "
                    "nbytes) in this function so readback_stats() stays "
                    "truthful",
                ))
    return findings
