# ballista-lint: path=ballista_tpu_torch/ops/lockorder_bad.py
"""BAD: an undeclared nesting acquired in BOTH orders (a cycle — a
potential deadlock), a raw unwitnessable threading.Lock with no
annotation, and a make_lock literal that lies about its identity."""
import threading

from ballista_tpu_torch.utils.locks import make_lock

_a_lock = make_lock("ops.lockorder_bad._a_lock")
_b_lock = make_lock("ops.lockorder_bad._b_lock")
_a_state = {}  # guarded-by: _a_lock
_b_state = {}  # guarded-by: _b_lock

_raw_lock = threading.Lock()  # raw + unannotated: two findings

_misnamed = make_lock("ops.other_module._misnamed")  # wrong canonical name


def transfer_ab(k, v):
    with _a_lock:
        _a_state[k] = v
        with _b_lock:  # undeclared edge a -> b
            _b_state[k] = v


def transfer_ba(k, v):
    with _b_lock:
        _b_state[k] = v
        with _a_lock:  # undeclared edge b -> a: CYCLE with transfer_ab
            _a_state[k] = v
