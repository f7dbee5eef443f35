"""Measured cost model for adaptive execution (the JAX package's
``ops/costmodel.py``, kept decision for decision).

Device-vs-host routing starts from static admission checks
(ops/kernels.py::JOIN_MULTIPLICITY_TIERS, the gather caps). This module
closes the loop: observed costs feed back into those routing decisions.

The store is a per-shape-bucket cost ledger persisted under
ballista.tpu.cost_model_dir (default .ballista_cache/costmodel):

  entry key = op | engine | power-of-two units bucket
  entry     = {s: total seconds, units: total work units, n: observations}

ops in use in this package:
- "join.gather" (units = padded gather elements) and "join.host" (units =
  build + probe rows, engine "host"): the device join's admission;
- "stage.run|<sha1 of the stage's stable key>" (units = leaf file bytes,
  or rows of a memory scan): one observation per fused stage run
  (ops/kernels.py);
- "h2d" (units = bytes of one upload chunk) and "readback" (units = bytes
  read back): ops/runtime.py's transfers, which the exchange registry
  prices its evictions at;
- "task.run|<shape>" (units = one task, engine "task") and "stage.batch"
  (units = members of a shared-scan batch, engine "task"): the scheduler's
  speculation thresholds and batch admission (scheduler/state.py);
- "mesh.agg|…" / "mesh.agg.host|…" and "join.mesh": the mesh stages'
  admission (parallel/spmd_stage.py, parallel/spmd_join.py).

The file is ``costs_torch.json``, not the JAX package's ``costs.json``: a
flush rewrites its file under its own fingerprint and drops entries of
another, so two packages sharing one directory would otherwise erase each
other's evidence.
Entries carry the fingerprint of the writer (torch version, CUDA version,
device name): a store written on another stack is ignored wholesale, since
costs measured on one device must never steer another.

Prediction is rate-based: predict(op, units) returns
units * (total_s / total_units), preferring the exact units bucket when it
has enough observations and falling back to the op-global rate. Updates
apply exponential forgetting (history halves once an entry saturates), and
a gross mispredict REPLACES the bucket's history with the observed cost
(`retier`), which pulls an over-eager extended admission back to the static
ladder.

The cost model only changes WHERE a join runs, never what it returns, and
the static ladder stays both the cold-start prior and the hard cap: a cold
or corrupt store reproduces the static routing exactly.

Persistence is best-effort: atomic tmp+rename writes, last-writer-wins per
key across processes; corrupt or fingerprint-mismatched files start an
empty store (recorded as a routing event, never raised).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Tuple

from ballista_tpu_torch.utils.locks import make_lock

# bump to orphan every persisted entry (they are re-measured, not migrated)
_FORMAT = 2
_STORE_BASENAME = "costs_torch.json"

# minimum observations before a rate is trusted for prediction
MIN_OBSERVATIONS = 4
# entry saturation: past this, history halves before each update so the
# rate follows the current machine instead of the all-time mean
_FORGET_AT = 32
# flush throttle: observe() persists at most this often (atexit and an
# explicit flush() cover the tail)
_FLUSH_INTERVAL_S = 5.0
# observed/predicted ratio beyond which a decision counts as a mispredict
MISPREDICT_FACTOR = 3.0

_lock = make_lock("ops.costmodel._lock")
_dir: str = ""  # "" = in-memory only; guarded-by: _lock
# lock-free: a single bool written by configure()/reset() and read on hot
# paths; a stale read costs at most one missed or extra observation
_enabled: bool = False
_loaded: bool = False  # guarded-by: _lock
_dirty: bool = False  # guarded-by: _lock
# bumped with every mutation; flush() clears _dirty only when the store it
# snapshotted is still current; guarded-by: _lock
_gen: int = 0
_last_flush: float = 0.0  # guarded-by: _lock
# key -> {"s": float, "units": float, "n": int}; guarded-by: _lock
_store: Dict[str, Dict[str, float]] = {}
_atexit_registered = False


def _record_event(event: str, n: int = 1) -> None:
    # through the module: the lock-order analyzer resolves `runtime.x` by
    # module, and this runs under _lock (the declared _lock -> counter edge)
    from ballista_tpu_torch.ops import runtime

    runtime.record_routing_event(event, n)


def enabled() -> bool:
    """Cheap hot-path gate (a bool read; staleness costs at most one missed
    or extra observation around configure)."""
    return _enabled


def configure(config) -> None:
    """Bind directory and enablement from a config. The last configuration
    wins; a directory change drops the in-memory store (entries reload
    lazily from the new path)."""
    global _dir, _enabled, _loaded, _dirty, _gen, _atexit_registered, _last_flush
    d = config.tpu_cost_model_dir()
    en = config.tpu_cost_model()
    with _lock:
        if d != _dir:
            _dir = d
            _store.clear()
            _gen += 1
            _loaded = False
            _dirty = False
            # start the flush throttle now: the first observation on a hot
            # path must not pay a synchronous disk round-trip
            _last_flush = time.monotonic()
        _enabled = en
        if not _atexit_registered:
            import atexit

            atexit.register(flush)
            _atexit_registered = True


def reset(clear_dir: bool = False) -> None:
    """Test hook: drop the in-memory store (and optionally forget the
    directory and disable the model), as in a fresh process."""
    global _dir, _enabled, _loaded, _dirty, _gen
    with _lock:
        _store.clear()
        _gen += 1
        _loaded = False
        _dirty = False
        if clear_dir:
            _dir = ""
            _enabled = False


def _fingerprint() -> str:
    """The writer's stack: torch version, CUDA version and device name."""
    import torch

    dev = torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"
    return f"cm{_FORMAT}|torch={torch.__version__}|cuda={torch.version.cuda}|{dev}"


def _bucket(units: float) -> int:
    """Power-of-two units bucket: a bounded set of entries per op."""
    b = 1
    u = max(1, int(units))
    while b < u:
        b <<= 1
    return b


def _key(op: str, engine: str, bucket: int) -> str:
    return f"{op}|{engine}|b{bucket}"


def task_run_op(shape: str) -> str:
    """Cost-store op for scheduler-side task durations of one stage shape.
    `shape` must already be job-independent (the caller scrubs the job id
    from the plan display) so repeated queries of the same shape share one
    rate across jobs: the straggler monitor predicts a fresh job's task
    cost from that history."""
    import hashlib

    return "task.run|" + hashlib.sha1(shape.encode()).hexdigest()[:12]


# holds-lock: _lock
def _load_locked() -> None:
    """Lazy-load the persisted store. Corruption or a fingerprint mismatch
    starts empty with the reason recorded: a bad store must reproduce
    cold-start routing, never crash or steer."""
    global _loaded
    if _loaded:
        return
    _loaded = True
    if not _dir:
        return
    path = os.path.join(_dir, _STORE_BASENAME)
    try:
        with open(path) as f:
            blob = json.load(f)
        if blob.get("format") != _FORMAT or blob.get("fingerprint") != _fingerprint():
            _record_event("cost_store_fingerprint_mismatch")
            return
        for k, e in blob.get("entries", {}).items():
            s, units, n = float(e["s"]), float(e["units"]), int(e["n"])
            if s < 0 or units <= 0 or n <= 0:
                raise ValueError(f"bad entry {k}")
            _store[k] = {"s": s, "units": units, "n": n}
    except FileNotFoundError:
        return
    except (OSError, ValueError, TypeError, KeyError, AttributeError):
        _store.clear()
        _record_event("cost_store_corrupt")


def flush() -> None:
    """Best-effort atomic persist (tmp+rename). Last-writer-wins per key:
    another process's entries for keys this one never touched survive;
    shared keys take this process's value. Never raises."""
    global _dirty, _last_flush
    with _lock:
        if not _dir or not _dirty:
            return
        entries = {k: dict(v) for k, v in _store.items()}
        base = _dir
        gen = _gen
    try:
        os.makedirs(base, exist_ok=True)
        path = os.path.join(base, _STORE_BASENAME)
        merged = dict(entries)
        try:
            with open(path) as f:
                blob = json.load(f)
            if (
                blob.get("format") == _FORMAT
                and blob.get("fingerprint") == _fingerprint()
            ):
                for k, e in blob.get("entries", {}).items():
                    merged.setdefault(k, e)
        except (OSError, ValueError, AttributeError):
            pass
        fd, tmp = tempfile.mkstemp(dir=base, prefix=".wip-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"format": _FORMAT, "fingerprint": _fingerprint(),
                           "entries": merged}, f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        with _lock:
            if _gen == gen:
                _dirty = False
            _last_flush = time.monotonic()
    except OSError:
        # advance the throttle all the same: an unwritable directory must
        # not make every later observe() retry a full flush
        with _lock:
            _last_flush = time.monotonic()


def observe(op: str, units: float, seconds: float, engine: str = "device") -> None:
    """Record one measured cost. A no-op while the model is disabled."""
    global _dirty, _last_flush, _gen
    if not _enabled or seconds < 0 or units <= 0:
        return
    k = _key(op, engine, _bucket(units))
    with _lock:
        _load_locked()
        e = _store.get(k)
        if e is None:
            _store[k] = {"s": float(seconds), "units": float(units), "n": 1}
        else:
            if e["n"] >= _FORGET_AT:
                e["s"] *= 0.5
                e["units"] *= 0.5
                e["n"] = e["n"] // 2
            e["s"] += float(seconds)
            e["units"] += float(units)
            e["n"] += 1
        _dirty = True
        _gen += 1
        due = bool(_dir) and time.monotonic() - _last_flush > _FLUSH_INTERVAL_S
        if due:
            # claim the flush slot under the lock so a burst of observes
            # starts one writer, and persist off the hot path
            _last_flush = time.monotonic()
    if due:
        threading.Thread(target=flush, daemon=True, name="costmodel-flush").start()


def seed(op: str, units: float, seconds: float, engine: str = "device",
         n: int = MIN_OBSERVATIONS) -> None:
    """Install a warm entry directly (tests and seeded runs); replaces any
    history for the bucket."""
    global _dirty, _gen
    with _lock:
        _load_locked()
        _store[_key(op, engine, _bucket(units))] = {
            "s": float(seconds), "units": float(units), "n": int(n),
        }
        _dirty = True
        _gen += 1


def retier(op: str, units: float, seconds: float, engine: str = "device") -> None:
    """Mispredict-driven re-tiering: REPLACE the bucket's history with the
    observed cost, so the next prediction reflects it."""
    global _dirty, _gen
    if not _enabled:
        return
    with _lock:
        _load_locked()
        _store[_key(op, engine, _bucket(units))] = {
            "s": float(seconds), "units": float(units), "n": MIN_OBSERVATIONS,
        }
        _dirty = True
        _gen += 1
    _record_event("retier")


def gross_mispredict(predicted: float, observed: float) -> bool:
    """True when observed deviates from predicted by MISPREDICT_FACTOR in
    either direction (the routing mispredict count and the re-tiering
    share this one definition)."""
    return (
        observed > MISPREDICT_FACTOR * predicted
        or observed * MISPREDICT_FACTOR < predicted
    )


def check_mispredict(op: str, units: float, predicted: Optional[float],
                     observed: float, engine: str = "device") -> bool:
    """Post-decision check: a gross mispredict (either way) re-tiers the
    bucket. Returns whether it fired."""
    if predicted is None or not gross_mispredict(predicted, observed):
        return False
    retier(op, units, observed, engine=engine)
    return True


@contextmanager
def timed(op: str, units: float = 1.0, engine: str = "device",
          routing_op: Optional[str] = None,
          predictive: bool = True) -> Iterator[None]:
    """Time the body as one measured decision: predict, observe, record the
    routing decision under `routing_op` (when given) and re-tier on a gross
    mispredict. A body exception skips the accounting (a failed attempt is
    not an observation of the op's cost); predictive=False degrades to a
    plain timed observation that never re-tiers."""
    predicted = predict(op, units, engine=engine) if predictive else None
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    observe(op, units, dt, engine=engine)
    if routing_op is not None:
        from ballista_tpu_torch.ops.runtime import record_routing

        record_routing(engine, routing_op, predicted, dt)
    if predictive:
        check_mispredict(op, units, predicted, dt, engine=engine)


def rate(op: str, engine: str = "device") -> Optional[Tuple[float, int]]:
    """Op-global (seconds per unit, observation count) across buckets, or
    None when nothing was observed."""
    prefix = f"{op}|{engine}|b"
    with _lock:
        _load_locked()
        s = units = 0.0
        n = 0
        for k, e in _store.items():
            if k.startswith(prefix):
                s += e["s"]
                units += e["units"]
                n += int(e["n"])
    if n == 0 or units <= 0:
        return None
    return s / units, n


def bucket_rate(op: str, units: float, engine: str = "device") -> Optional[float]:
    """Seconds per unit of the EXACT power-of-two bucket covering `units`,
    or None when the bucket is cold (< MIN_OBSERVATIONS) or the model is
    off. Unlike predict(), never falls back to the op-global rate: the h2d
    chunk picker (ops/runtime.py) compares candidate buckets against each
    other, and the global fallback would make every candidate tie."""
    if not _enabled:
        return None
    k = _key(op, engine, _bucket(units))
    with _lock:
        _load_locked()
        e = _store.get(k)
        if e is None or e["n"] < MIN_OBSERVATIONS or e["units"] <= 0:
            return None
        return e["s"] / e["units"]


def predict(op: str, units: float, engine: str = "device") -> Optional[float]:
    """Predicted seconds for `units` of `op` on `engine`: the exact units
    bucket when it has MIN_OBSERVATIONS, else the op-global rate, else None
    (cold: callers keep the static prior)."""
    if not _enabled:
        return None
    k = _key(op, engine, _bucket(units))
    with _lock:
        _load_locked()
        e = _store.get(k)
        if e is not None and e["n"] >= MIN_OBSERVATIONS and e["units"] > 0:
            return units * e["s"] / e["units"]
    r = rate(op, engine)
    if r is None or r[1] < MIN_OBSERVATIONS:
        return None
    return units * r[0]


def snapshot() -> Dict[str, Dict[str, float]]:
    """Copy of the in-memory store."""
    with _lock:
        _load_locked()
        return {k: dict(v) for k, v in _store.items()}
