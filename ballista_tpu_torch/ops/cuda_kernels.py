"""Hand-written CUDA kernels for the H100, their plain PyTorch versions,
their build and their launch counters.

Each kernel's source lives in ``ballista_tpu_torch/csrc/<name>.cu`` with a
plain C interface. ``build()`` compiles every source with ``nvcc`` for
``sm_90a`` into ``build/kernels/lib<name>.so`` at the repository root (one
``nvcc`` per source, all started together), and the library is loaded with
``ctypes``. Nothing is compiled or loaded when this module is imported.
``nvcc`` runs with ``-Xptxas -v``; its output is kept beside each library
(``lib<name>.log``), and ``build()`` returns each kernel's registers,
shared memory, stack and spills from it.

A wrapper takes its kernel's plain version only for tensors on the CPU. For
a CUDA tensor it launches the kernel or raises: a failed build or launch is
never hidden behind the plain version.

| wrapper              | replaces (JAX package)                           |
|----------------------|--------------------------------------------------|
| sorted_grouped_sum   | ops/pallas_kernels.py::sorted_grouped_sum        |
| grouped_aggregate    | ops/pallas_kernels.py::grouped_aggregate         |

``grouped_aggregate_arrays`` keeps the JAX entry's contract for numpy
arrays (``None`` above 128 groups); no stage route calls it.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# launches per kernel: each wrapper adds one where it launches its kernel,
# and nowhere else (the plain CPU version is not a launch)
_launches: Dict[str, int] = {"sorted_grouped_sum": 0, "grouped_aggregate": 0}

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


def _log_path(src: pathlib.Path) -> pathlib.Path:
    return BUILD_DIR / f"lib{src.stem}.log"


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads"
)
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def _demangle(names: List[str]) -> List[str]:
    tool = shutil.which("c++filt")
    if not tool or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def parse_ptxas(text: str) -> List[dict]:
    """Per kernel entry in ``nvcc -Xptxas -v`` output: its name (demangled
    where c++filt exists), registers, static shared memory bytes, stack
    frame bytes and spill store / load bytes."""
    facts: List[dict] = []
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            facts.append({"function": m.group(1), "registers": None,
                          "smem_bytes": 0, "stack_bytes": None,
                          "spill_stores": None, "spill_loads": None})
            continue
        if not facts:
            continue
        cur = facts[-1]
        m = _FRAME.search(line)
        if m:
            cur["stack_bytes"], cur["spill_stores"], cur["spill_loads"] = (
                int(g) for g in m.groups())
        m = _USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = _SMEM.search(line)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    for f, name in zip(facts, _demangle([f["function"] for f in facts])):
        f["function"] = name
    return facts


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
        newest = max(f.stat().st_mtime for f in [src, *CSRC.glob("*.cuh")])
        if lib.exists() and lib.stat().st_mtime >= newest:
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
        _log_path(src).write_text(out)
        os.replace(tmp, _lib_path(src))
        took[src.stem] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def build() -> Dict[str, dict]:
    """Build every kernel source now (a no-op for up-to-date libraries).
    Returns {name: {"seconds": compile seconds, or None when it was up to
    date, "ptxas": per-kernel registers, shared memory and spills}}."""
    with _build_lock:
        took = _build_locked()
    return {
        src.stem: {
            "seconds": took.get(src.stem),
            "ptxas": parse_ptxas(_log_path(src).read_text()) if _log_path(src).exists() else [],
        }
        for src in _sources()
    }


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
            if (name == "sorted_grouped_sum"
                    and lib.bt_sorted_grouped_sum_tile_rows() != SORTED_TILE_ROWS):
                raise RuntimeError(
                    f"{path}: tile rows {lib.bt_sorted_grouped_sum_tile_rows()} != "
                    f"SORTED_TILE_ROWS {SORTED_TILE_ROWS}"
                )
            _libs[name] = lib
        return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if name == "sorted_grouped_sum":
        fn = lib.bt_sorted_grouped_sum_f32
        fn.argtypes = [vp, vp, vp, vp, ll, i, ll, ll, vp]
        fn.restype = i
        lib.bt_sorted_grouped_sum_tile_rows.argtypes = []
        lib.bt_sorted_grouped_sum_tile_rows.restype = i
    elif name == "grouped_aggregate":
        fn = lib.bt_grouped_aggregate_f32
        fn.argtypes = [vp, vp, vp, vp, ll, i, i, i, i, ll, vp]
        fn.restype = i


def _check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


# -- sorted_grouped_sum -------------------------------------------------------
# rows per tile of the kernel (TILE in csrc/sorted_grouped_sum.cu, checked
# against the library when it loads) and value rows per pass over the codes
SORTED_TILE_ROWS = 2048
SORTED_VALUE_ROWS_PER_PASS = 4


def sorted_grouped_sum_geometry(n: int, nv: int):
    """(tiles, scratch shape, passes) of a kernel call over n rows and nv
    value rows: scratch holds each tile's first and last run sums per value
    row; the codes are read once per pass of up to 4 value rows."""
    tiles = -(-n // SORTED_TILE_ROWS)
    passes = -(-nv // SORTED_VALUE_ROWS_PER_PASS)
    return tiles, (tiles, 2, nv), passes


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
    if n == 0 or nv == 0 or num_groups == 0:
        return torch.zeros(nv, num_groups, dtype=torch.float32, device=values.device)
    # the kernel writes every output element once: no zero-fill
    out = torch.empty(nv, num_groups, dtype=torch.float32, device=values.device)
    tiles, scratch_shape, _ = sorted_grouped_sum_geometry(n, nv)
    scratch = torch.empty(scratch_shape, dtype=torch.float32, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.bt_sorted_grouped_sum_f32(
            codes.data_ptr(), values.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            n, nv, num_groups, tiles, stream,
        )
    _check_launch("sorted_grouped_sum", rc)
    _launches["sorted_grouped_sum"] += 1
    return out


# -- grouped_aggregate ---------------------------------------------------------
# the reference's group limit (its entry returns None above it)
GROUPED_AGGREGATE_MAX_GROUPS = 128
# the plain version's one-hot block, the reference's BLOCK_ROWS
_PLAIN_BLOCK = 1024
# blocks per batched one-hot product in the plain version (bounds its
# [blocks, 1024, G] one-hot temporary)
_PLAIN_BLOCKS_PER_STEP = 64
# one block's shared memory on sm_90: the kernel's [G, A] tile must fit
_MAX_TILE_BYTES = 232448
# the kernel's modes (csrc/grouped_aggregate.cu) and their limits
GA_MODE_REGISTERS, GA_MODE_WARP_TILES = 0, 1
_GA_REG_GROUPS, _GA_REG_COLUMNS = 8, 8
# bytes of values per ring tile of "registers", and the tile row cap
_GA_TILE_VALUE_BYTES = 32 * 1024
_GA_MAX_TILE_ROWS = 1024


def grouped_aggregate_geometry(n: int, num_groups: int, A: int):
    """(mode, tile rows, tiles) of a kernel call: "registers" (a ring of
    row tiles, sums in registers) for at most 8 groups and 8 columns, else
    "warp tiles" (rows read directly, per-warp [A, G] tiles in shared
    memory; tile rows unused). A ring tile holds about 32 KB of values, a
    multiple of 16 rows, at most 1024."""
    if num_groups <= _GA_REG_GROUPS and A <= _GA_REG_COLUMNS:
        mode = GA_MODE_REGISTERS
    else:
        mode = GA_MODE_WARP_TILES
    rows = max(1, _GA_TILE_VALUE_BYTES // (4 * max(A, 1)))
    if rows >= 16:
        rows -= rows % 16
    rows = min(rows, _GA_MAX_TILE_ROWS)
    return mode, rows, -(-n // rows)


def grouped_aggregate_plain(codes, values, mask, num_groups: int):
    """Plain PyTorch version, the reference's arithmetic: rows that are
    masked out are zeroed, then every block of 1024 rows adds
    onehot(codes)^T @ values into out (rows whose code lies outside
    [0, num_groups) match no column of the one-hot). A NaN in a row that is
    not masked out still spreads to every group of its column here (0 * NaN
    in the product), as in the reference; the kernel keeps it in its group."""
    import torch

    n, A = values.shape
    dev = values.device
    out = torch.zeros(num_groups, A, dtype=torch.float32, device=dev)
    if n == 0 or num_groups == 0:
        return out
    iota = torch.arange(num_groups, dtype=torch.int32, device=dev)
    step = _PLAIN_BLOCK * _PLAIN_BLOCKS_PER_STEP
    for s in range(0, n, step):
        c, v, m = codes[s:s + step], values[s:s + step], mask[s:s + step]
        pad = (-c.shape[0]) % _PLAIN_BLOCK
        if pad:  # the reference pads with code -1
            c = torch.cat([c, torch.full((pad,), -1, dtype=c.dtype, device=dev)])
            v = torch.cat([v, torch.zeros(pad, A, dtype=v.dtype, device=dev)])
            m = torch.cat([m, torch.zeros(pad, dtype=m.dtype, device=dev)])
        v = torch.where(m[:, None], v, 0.0)
        nb = c.shape[0] // _PLAIN_BLOCK
        onehot = (c.view(nb, _PLAIN_BLOCK, 1) == iota).to(torch.float32)
        out += torch.bmm(
            onehot.transpose(1, 2), v.view(nb, _PLAIN_BLOCK, A)
        ).sum(dim=0)
    return out


def grouped_aggregate(codes, values, mask, num_groups: int):
    """Masked per-group sums for at most 128 groups
    (csrc/grouped_aggregate.cu).

    codes: int32 [n]; rows whose code lies outside [0, num_groups) add
    nothing. values: float32 [n, A], contiguous. mask: bool [n]; rows where
    it is False add nothing, whatever their values (NaN included).
    Returns float32 [num_groups, A]. Any n is accepted (no padding)."""
    import torch

    if codes.dim() != 1 or values.dim() != 2 or mask.dim() != 1:
        raise ValueError("grouped_aggregate: codes must be [n], values [n, A], mask [n]")
    if not (values.shape[0] == codes.shape[0] == mask.shape[0]):
        raise ValueError(
            f"grouped_aggregate: codes {tuple(codes.shape)}, values "
            f"{tuple(values.shape)} and mask {tuple(mask.shape)} disagree on n"
        )
    if (codes.dtype != torch.int32 or values.dtype != torch.float32
            or mask.dtype != torch.bool):
        raise TypeError(
            f"grouped_aggregate: want int32 codes, float32 values and bool "
            f"mask, got {codes.dtype}, {values.dtype} and {mask.dtype}"
        )
    if not (codes.device == values.device == mask.device):
        raise ValueError("grouped_aggregate: inputs on different devices")
    if not 0 <= num_groups <= GROUPED_AGGREGATE_MAX_GROUPS:
        raise ValueError(
            f"grouped_aggregate: {num_groups} groups outside "
            f"[0, {GROUPED_AGGREGATE_MAX_GROUPS}]"
        )
    if codes.device.type == "cpu":
        return grouped_aggregate_plain(codes, values, mask, num_groups)
    if codes.device.type != "cuda":
        raise ValueError(f"grouped_aggregate: unsupported device {codes.device}")
    if not (codes.is_contiguous() and values.is_contiguous() and mask.is_contiguous()):
        raise ValueError("grouped_aggregate: inputs must be contiguous")
    n, A = values.shape
    if num_groups * A * 4 > _MAX_TILE_BYTES:
        raise ValueError(
            f"grouped_aggregate: a [{num_groups}, {A}] f32 tile exceeds one "
            "block's shared memory"
        )
    lib = _load("grouped_aggregate")
    out = torch.zeros(num_groups, A, dtype=torch.float32, device=values.device)
    if n == 0 or A == 0 or num_groups == 0:
        return out
    mode, tile_rows, tiles = grouped_aggregate_geometry(n, num_groups, A)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.bt_grouped_aggregate_f32(
            codes.data_ptr(), values.data_ptr(), mask.data_ptr(), out.data_ptr(),
            n, A, num_groups, mode, tile_rows, tiles, stream,
        )
    _check_launch("grouped_aggregate", rc)
    _launches["grouped_aggregate"] += 1
    return out


def grouped_aggregate_arrays(codes, values, mask, num_groups: int, device=None):
    """The JAX package's grouped_aggregate entry on numpy arrays:
    out[g, a] = sum of values[i, a] over rows with codes[i] == g and
    mask[i], as numpy float32 [G, A] read back through runtime.readback.
    Returns None above 128 groups and zeros when there are no rows.
    device=None runs on the card ("cuda"); pass a CPU device for the plain
    version."""
    import torch

    from ballista_tpu_torch.ops.runtime import readback, upload

    if num_groups > GROUPED_AGGREGATE_MAX_GROUPS:
        return None
    values = np.asarray(values, dtype=np.float32)
    if len(codes) == 0:
        return np.zeros((num_groups, values.shape[1]), dtype=np.float32)
    dev = torch.device("cuda" if device is None else device)
    out = grouped_aggregate(
        upload(np.asarray(codes, dtype=np.int32), dev),
        upload(values, dev),
        upload(np.asarray(mask, dtype=np.bool_), dev),
        num_groups,
    )
    return readback(out, rows=num_groups)
