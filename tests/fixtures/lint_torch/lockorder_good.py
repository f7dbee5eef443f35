# ballista-lint: path=ballista_tpu_torch/ops/lockorder_good.py
"""GOOD: canonical make_lock names, a manifest-declared forward nesting,
a holds-lock helper, the double-checked insert idiom, and a reviewed
(annotated) check-then-act — all clean under the lock-order rule."""
from ballista_tpu_torch.utils.locks import make_lock

_outer_lock = make_lock("ops.lockorder_good._outer_lock")
_inner_lock = make_lock("ops.lockorder_good._inner_lock")
_jobs = {}  # guarded-by: _outer_lock
_stats = {}  # guarded-by: _inner_lock


def record(job, n):
    # declared in lockorder.toml: _outer_lock ranks before _inner_lock
    with _outer_lock:
        _jobs[job] = n
        with _inner_lock:
            _stats["records"] = _stats.get("records", 0) + 1


# holds-lock: _outer_lock
def _drop_locked(job):
    _jobs.pop(job, None)


def drop(job):
    with _outer_lock:
        _drop_locked(job)


def cached(job, build):
    # double-checked insert: the re-read under the SECOND acquisition makes
    # the release window safe — not a check-then-act finding
    with _outer_lock:
        hit = _jobs.get(job)
    if hit is not None:
        return hit
    made = build(job)
    with _outer_lock:
        hit = _jobs.get(job)
        if hit is None:
            _jobs[job] = made
            hit = made
        return hit


def approximate_total(delta):
    with _inner_lock:
        total = _stats.get("total", 0)
    total = _clamp(total + delta)
    # atomicity-ok: best-effort estimate; last writer wins by design
    with _inner_lock:
        _stats["total"] = total


def refresh_total():
    with _inner_lock:
        total = _stats.get("total", 0)
    if total > 1000:
        return
    total = _rewalk()  # fresh reassignment KILLS the stale-read taint
    with _inner_lock:
        _stats["total"] = total


def _clamp(x):
    return max(0, x)


def _rewalk():
    return 0
