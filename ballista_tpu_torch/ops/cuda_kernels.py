"""Hand-written CUDA kernels for the H100, their plain PyTorch versions,
their build and their launch counters.

Each kernel's source lives in ``ballista_tpu_torch/csrc/<name>.cu`` with a
plain C interface. ``build()`` compiles every source with ``nvcc`` for
``sm_90a`` into ``build/kernels/lib<name>-<key>.so`` at the repository root
(one ``nvcc`` per source, all started together), and the library is loaded
with ``ctypes``. The key (``build_key``) hashes the source, the headers,
``NVCC_FLAGS``, ``nvcc --version`` and the card's compute capability, so a
library on disk is reused exactly when all of those match; events count in
``runtime.serving_stats()`` and ``prewarm`` loads every library before the
first query. Nothing is compiled or loaded when this module is imported.
``nvcc`` runs with ``-Xptxas -v``; its output is kept beside each library
(``lib<name>-<key>.log``), and ``build()`` returns each kernel's registers,
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
import hashlib
import json
import os
import pathlib
import re
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple

import numpy as np

from ballista_tpu_torch.errors import DeviceError
from ballista_tpu_torch.utils import counters
from ballista_tpu_torch.utils.locks import make_lock

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

_build_lock = make_lock("ops.cuda_kernels._build_lock")
_libs: Dict[str, ctypes.CDLL] = {}  # guarded-by: _build_lock
# per library compiled by this process: the seconds its nvcc took
_compiled_s: Dict[str, float] = {}  # guarded-by: _build_lock


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def loaded_libraries() -> Dict[str, Optional[float]]:
    """{name: compile seconds in this process, or None when the library
    was found on disk} for every kernel library this process has loaded."""
    with _build_lock:
        return {name: _compiled_s.get(name) for name in _libs}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise DeviceError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


# -- the keyed build cache ------------------------------------------------------
# A library is a function of its source, every header, NVCC_FLAGS, the nvcc
# release and the card's compute capability: each of those goes into its
# build key (the role of the JAX package's ops/aotcache.py::fingerprint), and
# the key goes into the library's file name. A changed flag, header, toolkit
# or card therefore builds anew and never reuses a stale library; a library
# whose key is on disk loads without nvcc. manifest.json in BUILD_DIR lists
# every entry built there.
_KEY_FORMAT = "ballista_tpu_torch kernels v1"
_toolchain_cache: Optional[Tuple[str, str, str]] = None  # guarded-by: _build_lock


def build_key(src: pathlib.Path, flags: List[str], nvcc_version: str,
              capability: str) -> str:
    """sha256 of what a library is built from: the source, every ``.cuh``
    beside it, the nvcc flags, ``nvcc --version`` and the compute
    capability ("9.0")."""
    h = hashlib.sha256()
    h.update(f"{_KEY_FORMAT}\0{src.name}\0".encode())
    h.update(src.read_bytes())
    for hdr in sorted(src.parent.glob("*.cuh")):
        h.update(f"\0{hdr.name}\0".encode())
        h.update(hdr.read_bytes())
    h.update(("\0flags\0" + "\0".join(flags)).encode())
    h.update(f"\0nvcc\0{nvcc_version}\0sm\0{capability}".encode())
    return h.hexdigest()


# holds-lock: _build_lock
def _toolchain() -> Tuple[str, str, str]:
    """(nvcc path, ``nvcc --version`` output, compute capability of the
    current card), found once per process."""
    global _toolchain_cache
    if _toolchain_cache is None:
        import torch

        nvcc = _nvcc()
        out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             timeout=120)
        if out.returncode != 0:
            raise DeviceError(f"{nvcc} --version failed: {out.stderr.strip()}")
        major, minor = torch.cuda.get_device_capability()
        _toolchain_cache = (nvcc, out.stdout.strip(), f"{major}.{minor}")
    return _toolchain_cache


def _lib_path(src: pathlib.Path, key: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{src.stem}-{key[:16]}.so"


def _log_path(src: pathlib.Path, key: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{src.stem}-{key[:16]}.log"


def _manifest_path() -> pathlib.Path:
    return BUILD_DIR / "manifest.json"


def manifest() -> Dict[str, dict]:
    """The build directory's entries: {key: {"name", "library", "flags",
    "nvcc", "capability", "built_at"}} ({} when there is none yet)."""
    try:
        return json.loads(_manifest_path().read_text())
    except (OSError, ValueError):
        return {}


def _record_manifest(entries: Dict[str, dict]) -> None:
    merged = {**manifest(), **entries}
    tmp = _manifest_path().with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(json.dumps(merged, indent=1, sort_keys=True))
    os.replace(tmp, _manifest_path())


def _compile(jobs: List[Tuple[pathlib.Path, pathlib.Path, str]]) -> List[Tuple[int, str]]:
    """Run one nvcc per (source, output, nvcc path) job, all started
    together; returns (return code, compiler output) per job."""
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(out), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, out, nvcc in jobs
    ]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, text) for p, text in zip(procs, outs)]


def _record_events(events: List[str]) -> None:
    """Count the kernel-library events a locked section collected, after
    it released _build_lock (a counter is never taken under it)."""
    for event in events:
        counters.serving.record(event)


# holds-lock: _build_lock
def _ensure_built_locked(events: List[str],
                         names: Optional[List[str]] = None) -> Dict[str, dict]:
    """Find or build the library of each source (all of them, or `names`).
    A library whose key is on disk adds "compile_hit_disk" to `events`; the
    rest are compiled, one nvcc per source started together, each adding
    "kernel_built". Returns {name: {"key", "library", "log", "seconds"
    (None when it was on disk)}}; raises with the compiler's output when a
    build fails."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, version, capability = _toolchain()
    out: Dict[str, dict] = {}
    todo = []
    for src in _sources():
        if names is not None and src.stem not in names:
            continue
        key = build_key(src, NVCC_FLAGS, version, capability)
        lib = _lib_path(src, key)
        out[src.stem] = {"key": key, "library": lib, "log": _log_path(src, key),
                         "seconds": None}
        if lib.exists():
            events.append("compile_hit_disk")
        else:
            todo.append((src, key))
    if not todo:
        return out
    t0 = time.perf_counter()
    jobs = [(src, _lib_path(src, key).with_suffix(f".{os.getpid()}.tmp"), nvcc)
            for src, key in todo]
    errors, built = [], {}
    for (src, key), (_s, tmp, _n), (rc, text) in zip(todo, jobs, _compile(jobs)):
        if rc != 0:
            errors.append(f"nvcc failed for {src.name} (rc {rc}):\n{text}")
            continue
        _log_path(src, key).write_text(text)
        os.replace(tmp, _lib_path(src, key))
        events.append("kernel_built")
        out[src.stem]["seconds"] = _compiled_s[src.stem] = time.perf_counter() - t0
        built[key] = {"name": src.stem, "library": _lib_path(src, key).name,
                      "flags": NVCC_FLAGS, "nvcc": version.splitlines()[-1],
                      "capability": capability, "built_at": time.time()}
    if built:
        _record_manifest(built)
    if errors:
        raise DeviceError("\n".join(errors))
    return out


def build() -> Dict[str, dict]:
    """Find or build every kernel library now (no nvcc for a library whose
    key is on disk). Returns {name: {"seconds": compile seconds, or None
    when it was on disk, "key": the build key, "library": its path,
    "ptxas": per-kernel registers, shared memory and spills}}."""
    events: List[str] = []
    try:
        with _build_lock:
            found = _ensure_built_locked(events)
    finally:
        _record_events(events)
    return {
        name: {
            "seconds": b["seconds"], "key": b["key"], "library": str(b["library"]),
            "ptxas": parse_ptxas(b["log"].read_text()) if b["log"].exists() else [],
        }
        for name, b in found.items()
    }


def prewarm(config, device=None) -> int:
    """Load every kernel library for the card before the first query (the
    JAX package's ops/aotcache.py::prewarm; an ExecutionContext calls it
    when ballista.tpu.prewarm is set). Returns the number of libraries
    loaded by this call, each counting "compile_prewarmed". On a CPU device
    it returns 0 and touches no nvcc. On a card a library that fails to
    build or load raises: a broken kernel is never skipped."""
    import torch

    del config  # the libraries depend on the sources and the card only
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return 0
    # the libraries not loaded yet are found or built together (one nvcc per
    # missing source, all started at once), then loaded
    events: List[str] = []
    try:
        with _build_lock:
            loaded = [src.stem for src in _sources() if src.stem not in _libs]
            found = _ensure_built_locked(events, loaded)
            for name in loaded:
                _load_locked(name, found[name])
    finally:
        _record_events(events)
    for src in _sources():
        if src.stem in loaded:
            counters.serving.record("compile_prewarmed")
        else:
            counters.serving.record("compile_hit_memory")
    return len(loaded)


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


def _load(name: str) -> ctypes.CDLL:
    events: List[str] = []
    try:
        with _build_lock:
            lib = _libs.get(name)
            if lib is not None:
                events.append("compile_hit_memory")
                return lib
            return _load_locked(name, _ensure_built_locked(events, [name])[name])
    finally:
        _record_events(events)


# holds-lock: _build_lock
def _load_locked(name: str, found: dict) -> ctypes.CDLL:
    """Load and bind the library `found` (an entry of _ensure_built_locked)."""
    path = found["library"]
    if not path.exists():
        raise DeviceError(f"kernel library {path} was not built")
    lib = ctypes.CDLL(str(path))
    _bind(name, lib)
    if (name == "sorted_grouped_sum"
            and lib.bt_sorted_grouped_sum_tile_rows() != SORTED_TILE_ROWS):
        raise DeviceError(
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
        raise DeviceError(f"{name}: CUDA launch failed with error {rc}")


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
