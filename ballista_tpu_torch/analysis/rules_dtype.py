"""dtype-discipline: the f64->f32 narrowing policy (ops/runtime.py module
docstring) — a float64 value must never reach a device transfer. Device
compute is f32/int32 by contract: the int packing of the readback assumes
32-bit lanes, and float64 runs at a fraction of the f32 rate on the card.

In device-path modules (ops/, parallel/), a value created as float64 —
`torch.float64`/`torch.double` (as a dtype argument, `.to(...)` or
`.type(...)`), `.double()`, `np.float64(...)`, `.astype(np.float64)` or a
creator's `dtype=` — must not flow into a device transfer:
`torch.as_tensor(..., device=)` / `torch.tensor(..., device=)`,
`.to(<device>)`, `.cuda()`, `runtime.upload(...)` or
`multihost.make_sharded(...)`; nor may a transfer itself name float64.

Host-side post-readback widening to float64 (Arrow result columns, the
int-exact host folds in ops/layout.py) is the documented result dtype and
is deliberately NOT flagged. ops/floatbits.py is exempt whole: its
f64<->i64 bijection is the documented exception to the narrowing policy.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ballista_tpu_torch.analysis.common import (
    Taint,
    dotted,
    final_name,
    is_device_path,
    iter_functions,
    walk_no_nested_defs,
)
from ballista_tpu_torch.analysis.core import Finding, SourceFile, register

RULE = "dtype-discipline"

_F64_NAMES = {"float64", "double"}
_CASTS = {"astype", "to", "type"}
# dtype names: a positional `.to(<dtype>)` argument is a cast, not a move
_DTYPE_NAMES = {
    "float16", "bfloat16", "float32", "float64", "float", "double", "half",
    "int8", "int16", "int32", "int64", "uint8", "bool", "bool_", "long",
    "int", "short",
}


def _mentions_f64(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, (ast.Attribute, ast.Name)) \
                and final_name(n) in _F64_NAMES:
            return True
        if isinstance(n, ast.Constant) and n.value in _F64_NAMES:
            return True
    return False


def _is_dtype_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in _DTYPE_NAMES
    name = dotted(node)
    return bool(name and "." in name
                and name.split(".")[0] in ("torch", "np", "numpy")
                and name.split(".")[-1] in _DTYPE_NAMES)


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _creates_f64(call: ast.Call) -> bool:
    """x.double(), np.float64(x), x.astype/.to/.type(<f64>), and any call
    with dtype=<f64> or a numpy creator's positional f64 dtype."""
    name = final_name(call.func)
    if name == "double" and isinstance(call.func, ast.Attribute) \
            and not call.args:
        return True
    if name == "float64":
        return True
    if name in _CASTS and isinstance(call.func, ast.Attribute):
        if any(_mentions_f64(a) for a in call.args):
            return True
    dtype = _kw(call, "dtype")
    if dtype is not None and _mentions_f64(dtype):
        return True
    base = dotted(call.func) or ""
    if base.split(".")[0] in ("np", "numpy") and call.args[1:] \
            and any(_mentions_f64(a) for a in call.args[1:]):
        return True
    return False


def _transfer_value(call: ast.Call) -> Optional[ast.AST]:
    """The value a device transfer moves, or None when `call` is not one.
    Returns the call itself when the transfer names no separate value
    (so its own dtype arguments are what gets checked)."""
    f = call.func
    name = dotted(f) or ""
    fin = final_name(f)
    if name in ("torch.as_tensor", "torch.tensor") \
            and _kw(call, "device") is not None:
        return call.args[0] if call.args else call
    if isinstance(f, ast.Attribute) and fin == "cuda" \
            and not name.startswith("torch."):
        return f.value
    if isinstance(f, ast.Attribute) and fin == "to":
        moves = _kw(call, "device") is not None or any(
            not _is_dtype_expr(a) for a in call.args
        )
        return f.value if moves else None
    if fin == "upload" and call.args:
        return call.args[0]
    if fin == "make_sharded" and len(call.args) > 1:
        return call.args[1]
    return None


def _transfer_names_f64(call: ast.Call) -> bool:
    fin = final_name(call.func)
    if fin == "make_sharded":
        dtype = call.args[3] if len(call.args) > 3 else _kw(call, "dtype")
        return dtype is not None and _mentions_f64(dtype)
    if fin == "to":
        return any(_mentions_f64(a) for a in call.args) or (
            _kw(call, "dtype") is not None and _mentions_f64(_kw(call, "dtype"))
        )
    dtype = _kw(call, "dtype")
    return dtype is not None and _mentions_f64(dtype)


@register(RULE)
def check(sf: SourceFile) -> List[Finding]:
    path = sf.path.replace("\\", "/")
    if path.endswith("ballista_tpu_torch/ops/floatbits.py") \
            or not is_device_path(sf.path):
        return []
    findings: List[Finding] = []
    for func, _cls in iter_functions(sf.tree):
        taint = Taint(func, lambda call, t: _creates_f64(call))
        for node in walk_no_nested_defs(func):
            if not isinstance(node, ast.Call):
                continue
            value = _transfer_value(node)
            if value is None:
                continue
            wide = _transfer_names_f64(node) or (
                value is not node and (
                    taint.expr_tainted(value)
                    or (isinstance(value, ast.Call) and _creates_f64(value))
                )
            )
            if wide:
                findings.append(Finding(
                    RULE, sf.path, node.lineno, node.col_offset,
                    "float64 value reaches a device transfer in "
                    f"'{func.name}' — narrow to f32/int32 first "
                    "(ops/runtime.py narrowing policy)",
                ))
    return findings
