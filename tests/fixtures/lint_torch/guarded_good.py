# ballista-lint: path=ballista_tpu_torch/ops/fixture_guarded_good.py
"""GOOD: every touch under the lock (or inside a holds-lock helper whose
callers hold it); __init__ registration is exempt."""
from ballista_tpu_torch.utils.locks import make_lock

_lock = make_lock("ops.fixture_guarded_good._lock")
_totals = {"rows": 0}  # guarded-by: _lock


def bump(n):
    with _lock:
        _totals["rows"] += n


# holds-lock: _lock
def _bump_locked(n):
    _totals["rows"] += n


def bump_via_helper(n):
    with _lock:
        _bump_locked(n)


class Registry:
    def __init__(self):
        self._mu = make_lock("ops.fixture_guarded_good._mu")
        self._entries = []  # guarded-by: self._mu

    def add(self, x):
        with self._mu:
            self._entries.append(x)


_sizes = {}  # store -> bytes; guarded-by: _lock


def note(store, n):
    with _lock:
        _sizes[store] = n


# the caller holds every member stage's prepare lock, taken by explicit
# acquire in id order; the lock class is another module's, named by its
# canonical name for the lock-order graph
# holds-lock: ops.stage._prepare_lock
def _run_members_locked(members):
    return [m.stage for m in members]


def run_members(members):
    held = {id(m.stage._prepare_lock): m.stage._prepare_lock for m in members}
    ordered = [held[k] for k in sorted(held)]
    for lk in ordered:
        lk.acquire()
    try:
        return _run_members_locked(members)  # rule adapted: a canonical holds-lock is checked by lock-order
    finally:
        for lk in reversed(ordered):
            lk.release()
