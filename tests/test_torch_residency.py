"""The port's device residency (ballista_tpu_torch/ops/runtime.py) against
the JAX package's (tests/test_residency.py): when the budget fills, other
stages' least recently touched pins are evicted, the requesting stage's own
pins never are, a victim far larger than the request stays, a stage evicted
within the cooldown is immune, and an entry that cannot fit streams.

Every scenario runs the same sequence of reserve_and_pin / touch_residency
/ release_stage_residency calls on both packages' runtimes and must give
the same decisions, the same cache contents and the same resident bytes.
The end-to-end cases alternate two real "sorted" stages, A, B, A, B, under
a budget that holds the larger but not both (each package's budget is its
own larger stage plus half the smaller): the per-run (pins, evictions,
streams) must be the same in both packages and equal to
chip_smoke.residency_sequence, which the smoke holds the card to. Both
packages' residency is reset before and after each test.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import ballista_tpu_torch.config as _port_config
from ballista_tpu.ops import runtime as jr
from ballista_tpu_torch.ops import runtime as tr

from test_torch_layout_cache import reset_jax, reset_port

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""

RUNTIMES = {"port": tr, "jax": jr}

# (pins, evictions, streams) per run of two equal stages alternating A, B,
# A, B, ... under a budget for one (chip_smoke.residency_sequence's even case)
ALTERNATING_RUNS = [(1, 0, 0), (1, 1, 0), (1, 1, 0), (0, 0, 1),
                    (0, 0, 0), (0, 0, 1), (0, 0, 0), (0, 0, 1)]


class _FakeStage:
    def __init__(self):
        self._device_cache = {}


@pytest.fixture(autouse=True)
def _clean_residency():
    reset_port()
    reset_jax()
    yield
    reset_port()
    reset_jax()


def _play(rt, steps):
    """Run `steps` on runtime `rt` with fresh fake stages; returns the
    observable outcome after every step: (decision, which stages hold which
    partitions, resident bytes)."""
    stages = {}
    out = []
    for step in steps:
        op, name = step[0], step[1]
        st = stages.setdefault(name, _FakeStage())
        if op == "pin":
            _, _, part, nbytes, budget = step
            res = rt.reserve_and_pin(st, part, {"x": name}, st._device_cache, nbytes, budget)
        elif op == "touch":
            res = rt.touch_residency(st, step[2])
        elif op == "headroom":
            res = rt.make_headroom(st, step[2], step[3])
        else:  # "release"
            res = rt.release_stage_residency(st)
        held = {n: sorted(s._device_cache) for n, s in sorted(stages.items())}
        out.append((res, held, rt.resident_bytes()))
    return out


SCENARIOS = {
    # a is touched after b, so c's need evicts b (the oldest), not a
    "lru_evicts_oldest_other_stage": [
        ("pin", "a", 0, 40, 100), ("pin", "b", 0, 40, 100), ("touch", "a", 0),
        ("pin", "c", 0, 40, 100)],
    # a second partition of the same stage never evicts the first
    "own_partitions_never_victims": [
        ("pin", "a", 0, 60, 100), ("pin", "a", 1, 60, 100)],
    # an entry that can never fit streams without disturbing other pins
    "oversized_entry_streams": [
        ("pin", "a", 0, 50, 100), ("pin", "b", 0, 150, 100)],
    # a victim over 4x the request stays resident: the newcomer streams
    "huge_victim_not_evicted": [
        ("pin", "a", 0, 95, 100), ("pin", "b", 0, 10, 100)],
    # two victims, oldest first, when one is not enough
    "multi_victim_plan": [
        ("pin", "a", 0, 30, 100), ("pin", "b", 0, 30, 100), ("pin", "c", 0, 80, 100)],
    # a stage evicted within the cooldown is immune: c streams
    "cooldown_immunity": [
        ("pin", "a", 0, 60, 100), ("pin", "b", 0, 60, 100), ("pin", "a", 0, 60, 100),
        ("pin", "c", 0, 60, 100)],
    # headroom before an upload evicts like a pin would, and pins nothing
    "headroom_before_upload": [
        ("pin", "a", 0, 60, 100), ("headroom", "b", 60, 100), ("pin", "b", 0, 60, 100)],
    # a released stage frees its bytes and refuses new pins
    "release_retires": [
        ("pin", "a", 0, 10, 100), ("release", "a"), ("pin", "a", 0, 10, 100)],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name):
    outcomes = {}
    for pkg, rt in RUNTIMES.items():
        rt.reset_residency()
        outcomes[pkg] = _play(rt, SCENARIOS[name])
    assert outcomes["port"] == outcomes["jax"]


def test_release_clears_lru_bookkeeping():
    a = _FakeStage()
    assert tr.reserve_and_pin(a, 0, {"x": 1}, a._device_cache, 10, 100)
    tr.release_stage_residency(a)
    assert tr.resident_bytes() == 0
    assert not tr._pinned and not tr._last_used


def test_eviction_keeps_a_running_consumer_alive():
    """An evicted entry's tensors stay alive for a thread that holds them:
    eviction drops only the cache slot."""
    import torch

    a, b = _FakeStage(), _FakeStage()
    t = torch.arange(8)
    assert tr.reserve_and_pin(a, 0, {"t": t}, a._device_cache, 60, 100)
    held = a._device_cache[0]["t"]
    assert tr.reserve_and_pin(b, 0, {"x": 1}, b._device_cache, 60, 100)
    assert 0 not in a._device_cache
    assert torch.equal(held, torch.arange(8))
    assert tr.residency_stats(reset=True) == {"pins": 2, "evictions": 1, "streams": 0}


def _alternate(pkg, make_ctx, pair):
    """Run the `pair` of sorted-stage queries (A, B) of one package A, B,
    A, B, A, B, A, B under a budget of the larger stage plus half the
    smaller (chip_smoke.py's phase 9 rule), each stage sized by one
    unconstrained run first. Returns the stage sizes and, per run, the
    (pins, evictions, streams) read off the package's residency ledger: new
    pinned tokens, tokens that left it, and prepares that did not pin. For
    the port also runtime.residency_stats() per run, which must agree."""
    from ballista_tpu.ops.stage import FusedAggregateStage as JaxStage
    from ballista_tpu_torch.ops.stage import FusedAggregateStage

    rt = RUNTIMES[pkg]
    cls = FusedAggregateStage if pkg == "port" else JaxStage
    reset = reset_port if pkg == "port" else reset_jax
    sizes, answers = [], {}
    for name, sql in pair:
        reset()
        answers[name] = make_ctx({}).sql(sql).collect()
        sizes.append(rt.resident_bytes())
    budget = max(sizes) + min(sizes) // 2
    reset()
    prepares = [0]
    originals = {m: getattr(cls, m) for m in ("_prepare_partition", "_prepare_partition_sorted")}

    def counting(orig):
        def run(self, partition, ctx):
            out = orig(self, partition, ctx)  # a decline is no prepare
            prepares[0] += 1
            return out
        return run

    for m, orig in originals.items():
        setattr(cls, m, counting(orig))
    derived, stats = [], []
    try:
        ctx = make_ctx({"ballista.tpu.hbm_budget_bytes": str(budget)})
        tr.residency_stats(reset=True)
        for _cycle in range(4):
            for name, sql in pair:
                before, n0 = set(rt._pinned), prepares[0]
                out = ctx.sql(sql).collect()
                assert out.equals(answers[name])
                after = set(rt._pinned)
                pins = len(after - before)
                derived.append((pins, len(before - after), prepares[0] - n0 - pins))
                c = tr.residency_stats(reset=True)
                stats.append((c["pins"], c["evictions"], c["streams"]))
    finally:
        for m, orig in originals.items():
            setattr(cls, m, orig)
    assert rt.resident_bytes() <= budget
    if pkg == "port":
        assert stats == derived
    return sizes, derived, answers


def _contexts(tables, settings):
    from ballista_tpu.config import BallistaConfig as JaxConfig
    from ballista_tpu.engine import ExecutionContext as JaxContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import ExecutionContext

    def port(extra):
        ctx = ExecutionContext(BallistaConfig({**settings, **extra}), device="cpu")
        for name, path in tables.items():
            ctx.register_parquet(name, path)
        return ctx

    def jax(extra):
        ctx = JaxContext(JaxConfig({**settings, **extra, "ballista.executor.backend": "tpu"}))
        for name, path in tables.items():
            ctx.register_parquet(name, path)
        return ctx

    return {"port": port, "jax": jax}


def test_two_equal_stages_alternate_as_in_reference(tmp_path):
    """Two file-backed "sorted" stages of the same size: the first cycle
    thrashes, then the cooldown keeps A pinned and B streams, in both
    packages, as chip_smoke.residency_sequence says."""
    import chip_smoke

    n, g = 60_000, 2500  # > 1024 groups: the sorted (one-upload) route
    tables = {}
    for name, seed in (("ta", 1), ("tb", 2)):
        r = np.random.default_rng(seed)
        tables[name] = str(tmp_path / f"{name}.parquet")
        pq.write_table(pa.table({
            "k": pa.array(r.integers(0, g, n), type=pa.int64()),
            "v": pa.array(r.uniform(-10, 10, n)),
        }), tables[name])
    pair = [(t, f"select k, sum(v) as s from {t} group by k order by k")
            for t in ("ta", "tb")]
    settings = {"ballista.tpu.layout_cache_dir": "", "ballista.tpu.cost_model_dir": ""}
    runs = {}
    for pkg, make_ctx in _contexts(tables, settings).items():
        sizes, runs[pkg], answers = _alternate(pkg, make_ctx, pair)
        assert runs[pkg] == chip_smoke.residency_sequence(*sizes)
        runs[pkg + "_answers"] = answers
    assert runs["port"] == runs["jax"] == ALTERNATING_RUNS
    for t, _sql in pair:
        a, b = runs["port_answers"][t], runs["jax_answers"][t]
        assert a.column("k").equals(b.column("k"))
        np.testing.assert_allclose(a.column("s").to_numpy(), b.column("s").to_numpy(),
                                   rtol=1e-4, atol=2e-3)


def test_tpch_pair_alternates_as_in_reference(tmp_path):
    """The pair chip_smoke.py's phase 9 alternates on the card, q18-inner
    and q15-revenue over TPC-H at SF 0.12 (past 1024 suppliers, so both take
    the "sorted" route, as at SF 1): both packages give the sequence
    chip_smoke.residency_sequence predicts for their stage sizes."""
    import chip_smoke
    from benchmarks.tpch.datagen import generate
    from benchmarks.tpch.schema import TPCH_TABLES

    generate(str(tmp_path), sf=0.12, parts=2, seed=20260728)
    tables = {t: str(tmp_path / t) for t in TPCH_TABLES}
    settings = {"ballista.tpu.layout_cache_dir": "", "ballista.tpu.cost_model_dir": ""}
    runs = {}
    for pkg, make_ctx in _contexts(tables, settings).items():
        sizes, runs[pkg], _answers = _alternate(pkg, make_ctx, chip_smoke.RESIDENCY_PAIR)
        assert runs[pkg] == chip_smoke.residency_sequence(*sizes), (pkg, sizes)
    assert runs["port"] == runs["jax"]
