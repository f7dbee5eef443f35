"""Order-preserving IEEE-754 <-> integer bijections.

The device computes in f32, but float MIN/MAX results must sometimes be the
bit-exact stored value (q2's decorrelated MIN(ps_supplycost) is
equality-joined back against the source column — a rounded f32 min matches
nothing). The fix is representational, not arithmetic: map float bits to
integers whose *signed integer order equals the float total order*, run the
existing exact integer min/max machinery on device, and invert on readback.
No rounding exists anywhere in that path.

Key construction (i = raw bits viewed as a signed integer of equal width):

    key(x) = i          if i >= 0     (+0.0, positives, +NaN)
           = INT_MIN-i  if i <  0     (-0.0, negatives, -NaN)

Properties, documented and tested (tests/test_floatbits.py):

- monotone total order: x < y  <=>  key(x) < key(y) for all non-NaN x, y,
  including negatives, subnormals and ±inf;
- ±0 collapse: key(-0.0) == key(+0.0) == 0. MIN/MAX treat the two zeros as
  equal (SQL equality does too) and decode returns +0.0;
- NaN policy: +NaN keys sort above +inf, -NaN keys below -inf. Aggregate
  consumers never rely on this — the stage declines to the host path when a
  min/max input column contains NaN, because Arrow's host min/max SKIPS NaN
  and no single key order can reproduce "never wins min AND never wins max";
- exact round-trip: decode(encode(x)) is bit-identical to x for every value
  except -0.0, which decodes to +0.0 (the documented collapse).

f64 keys additionally split into two int32 planes for the device (the
device step's min/max runs on int32 planes): hi = top 32 bits (signed, carries the order's coarse
component), lo = bottom 32 bits biased into int32 so that for equal hi the
signed int32 order of lo matches the key order. Lexicographic (hi, lo)
min/max equals int64 key min/max; the host recombines exactly.
"""

from __future__ import annotations

import numpy as np

_I32_MIN = np.int32(-(2**31))
_I64_MIN = np.int64(-(2**63))


# -- f32 <-> i32 -----------------------------------------------------------
def f32_to_i32(x: np.ndarray) -> np.ndarray:
    """Encode float32 values to order-preserving int32 keys."""
    i = np.asarray(x, dtype=np.float32).view(np.int32)
    return np.where(i >= 0, i, _I32_MIN - i)


def i32_to_f32(k: np.ndarray) -> np.ndarray:
    """Invert f32_to_i32 (key 0 -> +0.0; see module docstring)."""
    k = np.asarray(k, dtype=np.int32)
    return np.where(k >= 0, k, _I32_MIN - k).astype(np.int32).view(np.float32)


# -- f64 <-> i64 -----------------------------------------------------------
def f64_to_i64(x: np.ndarray) -> np.ndarray:
    """Encode float64 values to order-preserving int64 keys."""
    i = np.asarray(x, dtype=np.float64).view(np.int64)
    return np.where(i >= 0, i, _I64_MIN - i)


def i64_to_f64(k: np.ndarray) -> np.ndarray:
    """Invert f64_to_i64 (key 0 -> +0.0; see module docstring)."""
    k = np.asarray(k, dtype=np.int64)
    return np.where(k >= 0, k, _I64_MIN - k).astype(np.int64).view(np.float64)


# -- i64 key <-> two int32 device planes -----------------------------------
def i64_to_planes(k: np.ndarray):
    """Split int64 keys into (hi, lo) int32 planes whose lexicographic
    signed order equals the key order: hi is the arithmetic top half, lo the
    bottom 32 bits re-biased so unsigned lo order becomes signed int32
    order."""
    k = np.asarray(k, dtype=np.int64)
    hi = (k >> 32).astype(np.int32)
    lo = (k & np.int64(0xFFFFFFFF)).astype(np.int64) + np.int64(_I32_MIN)
    return hi, lo.astype(np.int32)


def planes_to_i64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Exact inverse of i64_to_planes. Accepts int64 inputs (device rows
    decode through the hi/lo f32-pair packing as int64)."""
    hi64 = np.asarray(hi, dtype=np.int64)
    lo64 = np.asarray(lo, dtype=np.int64) - np.int64(_I32_MIN)  # back to [0, 2^32)
    return hi64 * np.int64(1 << 32) + lo64


# -- on-device (torch) variants --------------------------------------------
def torch_f32_to_i32(x):
    """Device-side f32 -> key: a bit reinterpretation (``Tensor.view``)
    plus an integer select, no float arithmetic."""
    import torch

    i = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(i >= 0, i, torch.iinfo(torch.int32).min - i)


def torch_i32_to_f32(k):
    """Device-side key -> f32: exact inverse of torch_f32_to_i32."""
    import torch

    k = k.to(torch.int32)
    i = torch.where(k >= 0, k, torch.iinfo(torch.int32).min - k).to(torch.int32)
    return i.contiguous().view(torch.float32)

