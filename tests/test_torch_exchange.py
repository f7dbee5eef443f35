"""The port's exchange registry (ballista_tpu_torch/ops/exchange.py) against
the JAX package's (ballista_tpu/ops/exchange.py), after
tests/test_exchange.py: the same publish / resolve / resolve_path / evict /
evict_job sequence goes into both registries, and after every step the
returned values, the registry's keys and attempts, resident_bytes(), the
per-tenant bytes and exchange_stats() must be equal.

Sequences are made from a seed with numpy: two executors, two jobs, two
tenants, pieces of 8..200 int64 rows, budgets that force evictions. Each
runs with both cost models on and in memory, cold (eviction priced by
bytes) and with h2d / readback rates seeded into both stores (eviction
priced at the observed rates, which exchange.py reads through
costmodel.predict).
"""

import numpy as np
import pyarrow as pa
import pytest

from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.ops import costmodel as jcm
from ballista_tpu.ops import exchange as jex
from ballista_tpu.ops import runtime as jrt
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.ops import costmodel as tcm
from ballista_tpu_torch.ops import exchange as tex
from ballista_tpu_torch.ops import runtime as trt

MODEL = {"ballista.tpu.cost_model": "true", "ballista.tpu.cost_model_dir": ""}
TENANTS = ("alice", "bob")
ROWS = (8, 25, 50, 100, 200)


@pytest.fixture(autouse=True)
def _fresh():
    for ex, rt, cm in ((jex, jrt, jcm), (tex, trt, tcm)):
        ex.reset()
        rt.exchange_stats(reset=True)
        cm.reset(clear_dir=True)
    jcm.configure(JaxConfig(MODEL))
    tcm.configure(BallistaConfig(MODEL))
    yield
    for ex, rt, cm in ((jex, jrt, jcm), (tex, trt, tcm)):
        ex.reset()
        rt.exchange_stats(reset=True)
        cm.reset(clear_dir=True)


def _batch(rows: int, fill: int) -> pa.RecordBatch:
    return pa.record_batch({"v": pa.array(np.full(rows, fill, dtype=np.int64))})


def _ops(seed: int, n: int = 80):
    """A seeded sequence of registry calls (name, args, kwargs)."""
    rng = np.random.default_rng(seed)
    piece = _batch(ROWS[-1], 0).nbytes
    budget = int(piece * 2.5)
    ops = []
    for _ in range(n):
        ex = f"e{rng.integers(1, 3)}"
        job = f"j{rng.integers(1, 3)}"
        key = (ex, job, int(rng.integers(1, 3)), int(rng.integers(0, 4)), int(rng.integers(0, 2)))
        kind = rng.choice(["publish", "publish", "publish", "resolve", "resolve_path",
                           "evict", "evict_job", "stage_resident", "attempt_of"])
        path = "/w/{}/{}/{}/{}-{}.arrow".format(*key)
        if kind == "publish":
            rows = int(rng.choice(ROWS))
            attempt = int(rng.integers(0, 3))
            kw = {}
            if rng.random() < 0.5:
                kw = {"tenant": str(rng.choice(TENANTS)), "tenant_budget": int(piece * 1.5)}
            b = _batch(rows, int(rng.integers(0, 5)))
            ops.append(("publish", (*key, [b], b.schema, attempt,
                                    f"{path}@a{attempt}", budget), kw))
        elif kind == "resolve":
            ops.append(("resolve", key, {}))
        elif kind == "resolve_path":
            ops.append(("resolve_path", (f"{path}@a{int(rng.integers(0, 3))}",), {}))
        elif kind == "evict":
            ops.append(("evict", key, {}))
        elif kind == "evict_job":
            ops.append(("evict_job", (job,), {}))
        elif kind == "stage_resident":
            ops.append(("stage_resident", key[:4], {}))
        else:
            ops.append(("attempt_of", key, {}))
    return ops


def _plain(value):
    """A registry return value with its Arrow parts made comparable."""
    if isinstance(value, tuple):
        return tuple(_plain(v) for v in value)
    if isinstance(value, list):
        return [_plain(v) for v in value]
    if isinstance(value, pa.RecordBatch):
        return value.to_pydict()
    if isinstance(value, pa.Schema):
        return str(value)
    return value


def _state(ex, rt):
    with ex._reg_lock:
        entries = {k: (e.attempt, e.nbytes, e.tenant) for k, e in ex._entries.items()}
    return (entries, ex.resident_bytes(),
            {t: ex.tenant_resident_bytes(t) for t in TENANTS}, rt.exchange_stats())


def _seed_rates(cm):
    # every piece size's bucket observed: the small pieces' transfers slow,
    # the large ones' fast, so the price disagrees with the byte count
    for rows in ROWS:
        nbytes = float(_batch(rows, 0).nbytes)
        seconds = 10.0 if rows <= 25 else 1e-6
        cm.seed("h2d", nbytes, seconds)
        cm.seed("readback", nbytes, seconds)


@pytest.mark.parametrize("priced", [False, True], ids=["cold", "priced"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_decisions_as_reference(seed, priced):
    if priced:
        _seed_rates(jcm)
        _seed_rates(tcm)
    for name, args, kw in _ops(seed):
        got = getattr(tex, name)(*args, **kw)
        want = getattr(jex, name)(*args, **kw)
        assert _plain(got) == _plain(want), (name, args)
        port_state, ref_state = _state(tex, trt), _state(jex, jrt)
        assert port_state == ref_state, (name, args)
    # the sequences reach the budget decisions, not only the happy path
    stats = trt.exchange_stats()
    evicted = stats.get("evicted_budget", 0) + stats.get("evicted_tenant_budget", 0)
    assert stats.get("published", 0) > 0
    assert evicted + stats.get("skipped_budget", 0) > 0, stats


def test_evict_and_evict_job_match_reference():
    b = _batch(4, 1)
    for ex in (jex, tex):
        ex.publish("e1", "ja", 1, 0, 0, [b], b.schema, 0, "/pa", 1 << 20)
        ex.publish("e1", "jb", 1, 0, 0, [b], b.schema, 0, "/pb", 1 << 20)
        ex.publish("e2", "jb", 1, 1, 0, [b], b.schema, 0, "/pc", 1 << 20)
    for ex in (jex, tex):
        assert ex.evict("e1", "ja", 1, 0, 0)
        assert not ex.evict("e1", "ja", 1, 0, 0)
        assert ex.evict_job("jb") == 2
        assert ex.resident_bytes() == 0
        assert ex.resolve_path("/pb") is None
    assert trt.exchange_stats() == jrt.exchange_stats()
