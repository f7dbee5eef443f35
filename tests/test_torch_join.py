"""The port's device join (ballista_tpu_torch/ops/join.py) against the JAX
package's (ballista_tpu/ops/join.py), on CPU tensors (device="cpu") and
CPU JAX: the cases of tests/test_device_join.py and
tests/test_join_multiplicity.py, and the cost model's escapes of
tests/test_costmodel.py (split, extended tier, build-side swap).

Each case feeds both packages the same key codes, made with numpy from a
seed, and requires bit-equal build indices, probe indices and counts (order
included: probe-major, build rows ascending within a key), equal to the
host oracle physical/joinutil.py::join_indices where the device admits the
shape, and the same join_path_stats paths and reasons. Both cost stores are
in memory and emptied before each test.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import ballista_tpu_torch.config as _port_config
from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu.ops import costmodel as jcm
from ballista_tpu.ops import join as jj
from ballista_tpu.ops import kernels as jk
from ballista_tpu.ops import runtime as jr
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import ExecutionContext
from ballista_tpu_torch.ops import costmodel as tcm
from ballista_tpu_torch.ops import join as tj
from ballista_tpu_torch.ops import kernels as tk
from ballista_tpu_torch.ops import runtime as tr
from ballista_tpu_torch.physical.joinutil import join_indices
from ballista_tpu_torch.utils import counters

CPU = torch.device("cpu")
TOP_TIER = tk.JOIN_MULTIPLICITY_TIERS[-1]
MODEL_ON = {"ballista.tpu.cost_model": "true", "ballista.tpu.cost_model_dir": ""}

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""


@pytest.fixture(autouse=True)
def _fresh():
    tcm.reset(clear_dir=True)
    jcm.reset(clear_dir=True)
    for rt in (jr, tr):
        rt.join_path_stats(reset=True)
        rt.routing_stats(reset=True)
    yield
    tcm.reset(clear_dir=True)
    jcm.reset(clear_dir=True)


@pytest.fixture
def model_on():
    """(JAX config, port config) with the cost model on, both bound."""
    jcfg, tcfg = JaxConfig(MODEL_ON), BallistaConfig(MODEL_ON)
    jcm.configure(jcfg)
    tcm.configure(tcfg)
    return jcfg, tcfg


def _both(build, probe, configs=(None, None)):
    """(JAX result, port result, JAX join paths, port join paths)."""
    jres = jj.device_join_indices(build, probe, configs[0])
    jpaths = jr.join_path_stats(reset=True)
    tres = tj.device_join_indices(build, probe, CPU, configs[1])
    tpaths = tr.join_path_stats(reset=True)
    return jres, tres, jpaths, tpaths


def _assert_same(build, probe, configs=(None, None), oracle=True):
    jres, tres, jpaths, tpaths = _both(build, probe, configs)
    assert tpaths == jpaths
    assert (tres is None) == (jres is None)
    if tres is None:
        return tpaths
    for t, j in zip(tres, jres):
        assert t.dtype == j.dtype == np.int64
        np.testing.assert_array_equal(t, j)
    if oracle:
        bi, pi = join_indices(build, probe, "inner")
        np.testing.assert_array_equal(tres[0], bi)
        np.testing.assert_array_equal(tres[1], pi)
        np.testing.assert_array_equal(tres[2], np.bincount(pi, minlength=len(probe)))
    return tpaths


# -- basic shapes --------------------------------------------------------------

def test_basic_unique_keys():
    build = np.array([10, 3, 7, 1], dtype=np.int64)
    probe = np.array([7, 7, 2, 10, 1], dtype=np.int64)
    assert _assert_same(build, probe) == {"paths": {"device": 1}, "reasons": {}}
    build_idx, probe_idx, counts = tj.device_join_indices(build, probe, CPU)
    assert counts.tolist() == [1, 1, 0, 1, 1]
    assert build_idx.tolist() == [2, 2, 0, 3]
    assert probe_idx.tolist() == [0, 1, 3, 4]


def test_duplicate_keys_expand_in_build_order():
    build = np.array([5, 5, 6], dtype=np.int64)
    probe = np.array([5, 6, 5], dtype=np.int64)
    _assert_same(build, probe)
    build_idx, probe_idx, counts = tj.device_join_indices(build, probe, CPU)
    assert counts.tolist() == [2, 1, 2]
    assert build_idx.tolist() == [0, 1, 2, 0, 1]
    assert probe_idx.tolist() == [0, 0, 1, 2, 2]


@pytest.mark.parametrize("build,probe", [
    ([1, 2, 3], [2, -1, 3]),  # null probe key
    ([-1, -1, 3, 3], [-1, 3, -1]),  # nulls on both sides never match
    ([5, 5, 5, 9], [1, 2, 3]),  # no probe matches: zero-width result
], ids=["null_probe", "nulls_both_sides", "no_matches"])
def test_null_and_empty_runs(build, probe):
    build, probe = np.array(build, dtype=np.int64), np.array(probe, dtype=np.int64)
    assert _assert_same(build, probe) == {"paths": {"device": 1}, "reasons": {}}


@pytest.mark.parametrize("n", [1000, 5000])
def test_unique_build_random_probes(n):
    rng = np.random.default_rng(3)
    build = rng.permutation(n * 2)[:n].astype(np.int64)
    probe = rng.integers(0, n * 2, n * 3).astype(np.int64)
    _assert_same(build, probe)


@pytest.mark.parametrize("k", [1, 2, 7, 33, 200])
def test_random_multiplicities(k):
    rng = np.random.default_rng(100 + k)
    keys = np.arange(40, dtype=np.int64)
    build = np.repeat(keys, rng.integers(1, k + 1, len(keys)))
    rng.shuffle(build)
    probe = rng.integers(-1, 55, 3000).astype(np.int64)
    _assert_same(build, probe)


def test_all_duplicate_single_key():
    build = np.full(37, 4, dtype=np.int64)
    probe = np.array([4, 4, 5], dtype=np.int64)
    _assert_same(build, probe)
    build_idx, _probe_idx, counts = tj.device_join_indices(build, probe, CPU)
    assert counts.tolist() == [37, 37, 0]
    assert build_idx.tolist() == list(range(37)) * 2


def test_zipf_skewed_build_inside_the_ladder():
    rng = np.random.default_rng(9)
    counts = np.minimum(rng.zipf(1.4, 97), TOP_TIER)
    build = np.repeat(np.arange(97, dtype=np.int64), counts)
    rng.shuffle(build)
    probe = rng.integers(0, 120, 8000).astype(np.int64)
    _assert_same(build, probe)


# -- admission tiers and declines ----------------------------------------------

def test_tier_ladder_matches_reference():
    assert tk.JOIN_MULTIPLICITY_TIERS == jk.JOIN_MULTIPLICITY_TIERS
    assert tk.JOIN_EXTENDED_TIERS == jk.JOIN_EXTENDED_TIERS
    assert (tk.JOIN_GATHER_CAP, tk.JOIN_GATHER_HARD_CAP) == (
        jk.JOIN_GATHER_CAP, jk.JOIN_GATHER_HARD_CAP)
    for mult in (0, 1, 2, 4, 5, 16, 17, 64, 65, 256, 257, 1000):
        for slots in (16, 1024, 1 << 21, 1 << 22, tk.JOIN_GATHER_CAP, tk.JOIN_GATHER_CAP * 4):
            assert tk.join_multiplicity_tier(mult, slots) == jk.join_multiplicity_tier(mult, slots)
    assert tk.join_multiplicity_tier(2, 1024) == (4, None)
    tier, why = tk.join_multiplicity_tier(64, tk.JOIN_GATHER_CAP)
    assert tier is None and "cap" in why
    # width 1 is exempt from the cap
    assert tk.join_multiplicity_tier(1, tk.JOIN_GATHER_CAP * 4) == (1, None)


def test_tier_cap_uses_padded_probe_slots():
    """The cap is taken on bucket_rows(probes, 16) slots, as in the JAX
    package: 2^21 + 1 probes pad to 2^22 slots, so multiplicity 16 (2^26
    elements) is admitted and 17 (tier 64) is not."""
    assert tr.bucket_rows((1 << 21) + 1, 16) == jr.bucket_rows((1 << 21) + 1, 16) == 1 << 22
    assert tk.join_multiplicity_tier(16, 1 << 22) == (16, None)
    assert tk.join_multiplicity_tier(17, 1 << 22)[0] is None


def test_multiplicity_past_top_tier_steps_aside():
    build = np.full(TOP_TIER + 1, 1, dtype=np.int64)
    probe = np.array([1, 2], dtype=np.int64)
    paths = _assert_same(build, probe)
    assert paths["paths"] == {"step_aside": 1}
    assert any("exceeds top tier" in r for r in paths["reasons"])


@pytest.mark.parametrize("build,probe,reason", [
    (np.empty(0, np.int64), np.array([1], np.int64), "empty join side"),
    (np.array([1], np.int64), np.empty(0, np.int64), "empty join side"),
    (np.array([2**31 - 2], np.int64), np.array([1], np.int64), "join key codes exceed int32"),
], ids=["empty_build", "empty_probe", "codes_past_int32"])
def test_host_fallback_declines(build, probe, reason):
    paths = _assert_same(build, probe)
    assert paths == {"paths": {"host_fallback": 1},
                     "reasons": {f"host_fallback: {reason}": 1}}
    # the decline is a join event, never a stage route
    routing = tr.routing_stats(reset=True)
    assert routing["routes"] == {} and routing["reasons"] == {}
    assert routing["events"] == {"join:host": 1}


def test_membership_counts_match_reference_and_oracle():
    rng = np.random.default_rng(11)
    build = rng.integers(0, 40, 300).astype(np.int64)
    build[rng.integers(0, 300, 20)] = -1
    probe = rng.integers(0, 60, 500).astype(np.int64)
    probe[rng.integers(0, 500, 30)] = -1
    tcounts = tj.device_membership_counts(build, probe, CPU)
    jcounts = jj.device_membership_counts(build, probe)
    np.testing.assert_array_equal(tcounts, jcounts)
    _b, p = join_indices(build, probe, "inner")
    np.testing.assert_array_equal(tcounts, np.bincount(p, minlength=len(probe)))
    assert tcounts.dtype == np.int64 and not tcounts[probe < 0].any()
    assert tr.join_path_stats() == jr.join_path_stats() == {"paths": {"device": 1}, "reasons": {}}
    assert tr.routing_stats()["events"] == {"join.counts:device": 1}


def test_membership_counts_readback_matches_reference(monkeypatch):
    """One int32 per padded probe slot, in one readback, as in the JAX
    package (bucket_rows(500, 16) = 512 slots)."""
    build = np.arange(40, dtype=np.int64)
    probe = np.arange(500, dtype=np.int64) % 60
    jr.readback_stats(reset=True)
    jj.device_membership_counts(build, probe)
    want = jr.readback_stats(reset=True)
    tr.readback_stats(reset=True)
    tj.device_membership_counts(build, probe, CPU)
    # the join's share: its readbacks carry the site "join"
    got = counters.readback.stats()
    assert {k: got[f"join.{k}"] for k in want} == tr.readback_stats(reset=True) == want
    assert want == {"rows": 512, "bytes": 512 * 4, "readbacks": 1}


# -- the cost model's escapes ----------------------------------------------------

def _skewed_join(monster_mult=TOP_TIER + 60, tail=1500, n_probe=3000, seed=3):
    """One monster key past the top static tier plus a unique tail; probes
    guaranteed to hit the monster."""
    rng = np.random.default_rng(seed)
    build = np.concatenate([np.arange(tail, dtype=np.int64),
                            np.full(monster_mult, tail // 2, dtype=np.int64)])
    rng.shuffle(build)
    probe = np.concatenate([rng.integers(-1, tail + 50, n_probe - 2).astype(np.int64),
                            np.full(2, tail // 2, dtype=np.int64)])
    return build, probe


def _zipf_hot_build(seed=21):
    """A zipf-skewed build whose few heaviest keys run past the top tier."""
    rng = np.random.default_rng(seed)
    counts = np.minimum(rng.zipf(2.0, 2000), 5000)
    build = np.repeat(np.arange(2000, dtype=np.int64), counts)
    rng.shuffle(build)
    probe = rng.integers(0, 2100, 4000).astype(np.int64)
    return build, probe


@pytest.mark.parametrize("shape", ["monster", "zipf"])
def test_skewed_build_splits(model_on, shape):
    build, probe = _skewed_join() if shape == "monster" else _zipf_hot_build()
    counts = np.bincount(build)
    assert counts.max() > TOP_TIER and (counts > TOP_TIER).sum() <= tj._SPLIT_MAX_HOT_KEYS
    paths = _assert_same(build, probe, model_on)
    assert paths == {"paths": {"split": 1},
                     "reasons": {"split: partial offload at the tier boundary": 1}}
    events = tr.routing_stats(reset=True)["events"]
    assert events.get("split") == 1 and events.get("join:split") == 1


@pytest.mark.parametrize("settings", [None, {"ballista.tpu.cost_model": "false"}],
                         ids=["no_config", "model_off"])
def test_skewed_build_without_model_steps_aside(settings):
    build, probe = _skewed_join()
    configs = (None, None) if settings is None else (JaxConfig(settings), BallistaConfig(settings))
    assert _assert_same(build, probe, configs)["paths"] == {"step_aside": 1}


def test_broad_duplication_is_not_split(model_on):
    rng = np.random.default_rng(9)
    hot_keys = np.arange(24, dtype=np.int64)  # more than _SPLIT_MAX_HOT_KEYS
    build = np.concatenate([np.repeat(hot_keys, TOP_TIER + 10),
                            np.arange(100, 400, dtype=np.int64)])
    rng.shuffle(build)
    probe = np.concatenate([np.repeat(hot_keys, 2),
                            rng.integers(0, 400, 500).astype(np.int64)])
    assert _assert_same(build, probe, model_on)["paths"] == {"step_aside": 1}


def test_extended_tier_under_a_seeded_store(model_on):
    """With a store that makes the width-512 gather cheap and the host join
    dear, a multiplicity-300 join runs on the device at tier 512 in both
    packages."""
    build, probe = _skewed_join(monster_mult=300)
    slots = tr.bucket_rows(len(probe), 16)
    for cm in (jcm, tcm):
        cm.seed("join.gather", slots * tk.JOIN_EXTENDED_TIERS[0], 1e-4)
        cm.seed("join.host", len(build) + len(probe), 10.0, engine="host")
    assert tk.join_extended_tier(300, slots, len(build) + len(probe))[0] == 512
    paths = _assert_same(build, probe, model_on)
    assert paths == {"paths": {"device": 1},
                     "reasons": {"device: extended tier past the static ladder": 1}}
    assert tr.routing_stats(reset=True)["events"].get("join.extended:device") == 1


def test_extended_tier_cold_store_declines(model_on):
    assert tk.join_extended_tier(TOP_TIER + 10, 1024, 100_000) is None
    assert jk.join_extended_tier(TOP_TIER + 10, 1024, 100_000) is None


def _tables(bkeys, pkeys):
    return (pa.table({"bk": pa.array(bkeys, type=pa.int64())}),
            pa.table({"pk": pa.array(pkeys, type=pa.int64())}))


def test_build_side_swap(model_on):
    """A planned build side over 4x the probe swaps sides; the restored
    probe-major order is bit-identical to the unswapped run, the JAX
    package's and the oracle."""
    rng = np.random.default_rng(13)
    build, probe = _tables(np.arange(9000), rng.integers(0, 9500, 400))
    jres = jj.try_device_inner_join(build, probe, ["bk"], ["pk"], config=model_on[0])
    tres = tj.try_device_inner_join(build, probe, ["bk"], ["pk"], CPU, config=model_on[1])
    assert tr.routing_stats(reset=True)["events"].get("join_build_swapped") == 1
    assert tr.join_path_stats(reset=True) == jr.join_path_stats(reset=True)
    plain = tj.try_device_inner_join(build, probe, ["bk"], ["pk"], CPU)
    for t, j, p in zip(tres, jres, plain):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, p)


def test_failed_build_swap_records_one_decision(model_on):
    """A swapped attempt that declines leaves no trace: one join, one
    decision (the planned sides on the device), no fallback counted."""
    from ballista_tpu_torch.utils import tracing

    rng = np.random.default_rng(17)
    pk = np.repeat(np.arange(20, dtype=np.int64), 300)
    rng.shuffle(pk)
    build, probe = _tables(np.arange(25_000), pk)
    before = tracing.counters()
    tres = tj.try_device_inner_join(build, probe, ["bk"], ["pk"], CPU, config=model_on[1])
    jres = jj.try_device_inner_join(build, probe, ["bk"], ["pk"], config=model_on[0])
    bi, pi = join_indices(np.arange(25_000), pk, "inner")
    for t, j, o in zip(tres, jres, (bi, pi)):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, o)
    routing = tr.routing_stats(reset=True)
    assert routing["events"] == {"join:device": 1}
    assert tr.join_path_stats(reset=True) == jr.join_path_stats(reset=True) == {
        "paths": {"device": 1}, "reasons": {}}
    assert tracing.counters().get("device.host_fallback", 0) == before.get("device.host_fallback", 0)


# -- through SQL ---------------------------------------------------------------

def _q3_shaped_tables():
    """orders (build side, many orders per customer) joined to customer on
    a non-unique build key; 40 custkeys have no customer."""
    rng = np.random.default_rng(42)
    n_cust = 300
    customer = pa.table({
        "c_custkey": pa.array(np.arange(n_cust), type=pa.int64()),
        "c_name": pa.array([f"Customer#{i:09d}" for i in range(n_cust)]),
    })
    per_cust = np.minimum(rng.zipf(1.3, n_cust + 40), 120)
    o_custkey = np.repeat(np.arange(n_cust + 40, dtype=np.int64), per_cust)
    rng.shuffle(o_custkey)
    n_ord = len(o_custkey)
    orders = pa.table({
        "o_orderkey": pa.array(np.arange(n_ord), type=pa.int64()),
        "o_custkey": pa.array(o_custkey),
        "o_totalprice": pa.array(np.round(rng.uniform(1000, 400000, n_ord), 2)),
    })
    return customer, orders


@pytest.mark.parametrize("device_join", ["true", "false"])
def test_duplicate_build_key_join_through_sql(device_join):
    """A q3-shaped join through the SQL engine: the port's "cuda" backend
    (CPU tensors), the JAX "tpu" backend and the port's "cpu" backend give
    the same rows in the same order, with the same join paths."""
    customer, orders = _q3_shaped_tables()
    sql = ("select o_orderkey, c_name, o_totalprice from orders, customer "
           "where o_custkey = c_custkey")
    settings = {"ballista.tpu.device_join": device_join}
    out, paths = {}, {}
    for name, ctx, rt in (
        ("jax", JaxContext(JaxConfig({**settings, "ballista.executor.backend": "tpu"})), jr),
        ("port", ExecutionContext(BallistaConfig(settings), device="cpu"), tr),
        ("host", ExecutionContext(BallistaConfig({"ballista.executor.backend": "cpu"}),
                                  device="cpu"), tr),
    ):
        ctx.register_record_batches("customer", customer, n_partitions=1)
        ctx.register_record_batches("orders", orders, n_partitions=1)
        rt.join_path_stats(reset=True)
        out[name] = ctx.sql(sql).collect().to_pylist()
        paths[name] = rt.join_path_stats(reset=True)
    assert out["port"] == out["jax"] == out["host"]
    assert paths["port"] == paths["jax"]
    assert paths["host"] == {"paths": {}, "reasons": {}}
    want = {"device": 1} if device_join == "true" else {}
    assert paths["port"]["paths"] == want
