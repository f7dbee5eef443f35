"""Hand-written CUDA kernels for the H100, their plain PyTorch versions,
their build and their launch counters.

Each kernel's source lives in ``ballista_tpu_torch/csrc/<name>.cu`` with a
plain C interface. ``build()`` compiles every source with ``nvcc`` for
``sm_90a`` into ``build/kernels/lib<name>.so`` at the repository root (one
``nvcc`` per source, all started together), and the library is loaded with
``ctypes``. Nothing is compiled or loaded when this module is imported.

A wrapper takes its kernel's plain version only for tensors on the CPU. For
a CUDA tensor it launches the kernel or raises: a failed build or launch is
never hidden behind the plain version.

| wrapper              | replaces (JAX package)                           |
|----------------------|--------------------------------------------------|
| sorted_grouped_sum   | ops/pallas_kernels.py::sorted_grouped_sum        |
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

# launches per kernel: each wrapper adds one where it launches its kernel,
# and nowhere else (the plain CPU version is not a launch)
_launches: Dict[str, int] = {"sorted_grouped_sum": 0}

_build_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # guarded-by: _build_lock


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    return BUILD_DIR / f"lib{src.stem}.so"


# holds-lock: _build_lock
def _build_locked(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Compile the sources that are missing or stale, one nvcc process per
    source, all started together. Returns {name: seconds} of what was
    compiled; raises with the compiler's output when one fails."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = []
    for src in _sources():
        if names is not None and src.stem not in names:
            continue
        lib = _lib_path(src)
        if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
            continue
        todo.append(src)
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = _lib_path(src).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    took: Dict[str, float] = {}
    errors = []
    for src, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {src.name} (rc {p.returncode}):\n{out}")
            continue
        os.replace(tmp, _lib_path(src))
        took[src.stem] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def build() -> Dict[str, float]:
    """Build every kernel source now (a no-op for up-to-date libraries)."""
    with _build_lock:
        return _build_locked()


def _load(name: str) -> ctypes.CDLL:
    with _build_lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked([name])
            path = BUILD_DIR / f"lib{name}.so"
            if not path.exists():
                raise RuntimeError(f"kernel library {path} was not built")
            lib = ctypes.CDLL(str(path))
            _bind(name, lib)
            _libs[name] = lib
        return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if name == "sorted_grouped_sum":
        fn = lib.bt_sorted_grouped_sum_f32
        fn.argtypes = [vp, vp, vp, ll, i, ll, vp]
        fn.restype = i


def _check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


# -- sorted_grouped_sum -------------------------------------------------------
def sorted_grouped_sum_plain(codes, values, num_groups: int):
    """Plain PyTorch version: out[v, g] = sum of values[v, i] over rows with
    codes[i] == g."""
    import torch

    out = torch.zeros(
        values.shape[0], num_groups, dtype=torch.float32, device=values.device
    )
    return out.index_add_(1, codes.long(), values)


def sorted_grouped_sum(codes, values, num_groups: int):
    """Per-group sums over sorted dense ranks (csrc/sorted_grouped_sum.cu).

    codes: int32 [n], sorted ascending, values in [0, num_groups).
    values: float32 [nv, n], contiguous, pre-masked.
    Returns float32 [nv, num_groups]. Any n is accepted (no block padding).
    Row sums are exact integers (counts) only up to 2^24 rows per group."""
    import torch

    if codes.dim() != 1 or values.dim() != 2:
        raise ValueError("sorted_grouped_sum: codes must be [n], values [nv, n]")
    if values.shape[1] != codes.shape[0]:
        raise ValueError(
            f"sorted_grouped_sum: values {tuple(values.shape)} do not match "
            f"codes {tuple(codes.shape)}"
        )
    if codes.dtype != torch.int32 or values.dtype != torch.float32:
        raise TypeError(
            f"sorted_grouped_sum: want int32 codes and float32 values, got "
            f"{codes.dtype} and {values.dtype}"
        )
    if codes.device != values.device:
        raise ValueError("sorted_grouped_sum: codes and values on different devices")
    if num_groups < 0:
        raise ValueError("sorted_grouped_sum: negative group count")
    if codes.device.type == "cpu":
        return sorted_grouped_sum_plain(codes, values, num_groups)
    if codes.device.type != "cuda":
        raise ValueError(f"sorted_grouped_sum: unsupported device {codes.device}")
    if not (codes.is_contiguous() and values.is_contiguous()):
        raise ValueError("sorted_grouped_sum: inputs must be contiguous")
    lib = _load("sorted_grouped_sum")
    nv, n = values.shape
    out = torch.zeros(nv, num_groups, dtype=torch.float32, device=values.device)
    if n == 0 or nv == 0 or num_groups == 0:
        return out
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.bt_sorted_grouped_sum_f32(
            codes.data_ptr(), values.data_ptr(), out.data_ptr(),
            n, nv, num_groups, stream,
        )
    _check_launch("sorted_grouped_sum", rc)
    _launches["sorted_grouped_sum"] += 1
    return out
