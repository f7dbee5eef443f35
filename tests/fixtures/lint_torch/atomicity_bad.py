# ballista-lint: path=ballista_tpu_torch/ops/atomicity_bad.py
"""BAD: check-then-act across a lock release — the read-modify-write of
guarded state spans two acquisitions, so a concurrent writer's update in
the release window is silently lost."""
from ballista_tpu_torch.utils.locks import make_lock

_mu = make_lock("ops.atomicity_bad._mu")
_state = {"n": 0}  # guarded-by: _mu


def lost_update(delta):
    with _mu:
        cur = _state["n"]
    cur = cur + delta  # derived from the stale read: taint propagates
    with _mu:
        _state["n"] = cur  # flagged: re-acquired write from a stale read
