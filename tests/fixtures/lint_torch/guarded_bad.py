# ballista-lint: path=ballista_tpu_torch/ops/fixture_guarded_bad.py
"""BAD: guarded state touched without its lock; a holds-lock helper called
lock-free."""
import threading

_lock = threading.Lock()
_totals = {"rows": 0}  # guarded-by: _lock


def bump(n):
    _totals["rows"] += n  # no lock


# holds-lock: _lock
def _bump_locked(n):
    _totals["rows"] += n


def bump_via_helper(n):
    _bump_locked(n)  # caller does not hold _lock


class Registry:
    def __init__(self):
        self._mu = threading.Lock()
        self._entries = []  # guarded-by: self._mu

    def add(self, x):
        self._entries.append(x)  # no lock


_sizes = {}  # store -> bytes; guarded-by: _lock


def note(store, n):
    _sizes[store] = n  # no lock; rule adapted: an annotation after a description counts
