"""The port's mapped fact scan (ballista_tpu_torch/ops/mappedscan.py) and the
stage ladder of ops/kernels.py against the JAX package's, on the same data:
the cases of tests/test_mappedscan.py, each run through the JAX "tpu"
backend (CPU JAX) and the port's "cuda" backend on CPU tensors
(device="cpu"). Both packages must build the same stages (a
FusedAggregateStage over a MappedScanExec, with the same "batches" /
"sorted" kind) or decline alike.

Tolerances (tests/test_mappedscan.py's own): non-float columns equal;
floats within rtol 1e-4 (rtol 1e-3 on TPC-H, :258). The hand oracles of the
reference tests are kept where they have one.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import ExecutionContext


def _fresh():
    from ballista_tpu.ops import kernels as jk
    from ballista_tpu.ops import runtime as jr
    from ballista_tpu_torch.ops import kernels as tk
    from ballista_tpu_torch.ops import runtime as tr

    jk._stage_cache.clear()
    jk._stage_cache_pins.clear()
    jk._stage_latest.clear()
    jr.reset_residency()
    tk.clear_stage_cache()
    tr.readback_stats(reset=True)
    tr.routing_stats(reset=True)


def _stages(cache):
    """Sorted descriptions of a stage cache's built stages: ("fact", mode)
    or (row source type, prepared kinds, fused top-k live)."""
    out = []
    for s in cache.values():
        if s in (None, False):
            continue
        if type(s).__name__ == "FactAggregateStage":
            mode = ("secondary" if s.secondary is not None
                    else "topk" if s.topk is not None else "select")
            out.append(("fact", mode))
        else:
            kinds = tuple(sorted({e.get("kind") for e in s._device_cache.values()}))
            out.append((type(s.scan).__name__, kinds, s.topk is not None))
    return sorted(out)


def _run_both(paths, sql, settings=None):
    """(JAX result, JAX stages, port result, port stages, port routing);
    `settings` go to both packages' configurations."""
    from ballista_tpu.ops import kernels as jk
    from ballista_tpu_torch.ops import kernels as tk
    from ballista_tpu_torch.ops import runtime as tr

    _fresh()
    # the reference run needs no AOT disk tier: exporting each traced
    # program to .ballista_cache/aot was a large share of its time
    settings = dict(settings or {})
    jctx = JaxContext(JaxConfig({"ballista.executor.backend": "tpu",
                                 "ballista.tpu.aot_cache": "", **settings}))
    pctx = ExecutionContext(BallistaConfig({"ballista.executor.backend": "cuda",
                                            **settings}), device="cpu")
    for name, p in paths.items():
        jctx.register_parquet(name, p)
        pctx.register_parquet(name, p)
    jout = jctx.sql(sql).collect()
    pout = pctx.sql(sql).collect()
    return (jout, _stages(jk._stage_cache), pout, _stages(tk._stage_cache),
            tr.routing_stats(reset=True))


def _assert_same(jout, pout, rtol):
    assert pout.column_names == jout.column_names
    assert pout.num_rows == jout.num_rows
    for name, f in zip(jout.column_names, jout.schema):
        j, p = jout.column(name).to_pylist(), pout.column(name).to_pylist()
        if pa.types.is_floating(f.type):
            np.testing.assert_allclose(np.array(p, dtype=float), np.array(j, dtype=float),
                                       rtol=rtol, err_msg=name)
        else:
            assert p == j, name


def _write(tmp_path, name, table):
    p = tmp_path / f"{name}.parquet"
    pq.write_table(table, str(p))
    return str(p)


def _star(tmp_path, n_fact=30_000, n_dim=800, missing=50, seed=7):
    """tests/test_mappedscan.py's star: `missing` fact keys have no dim row,
    and a second-level dim is keyed on a dim column."""
    rng = np.random.default_rng(seed)
    fact = pa.table({
        "fk": pa.array(rng.integers(0, n_dim + missing, n_fact), type=pa.int64()),
        "mode": pa.array([f"m{i % 5}" for i in range(n_fact)]),
        "amount": pa.array(rng.uniform(0, 100, n_fact)),
    })
    dim = pa.table({
        "dk": pa.array(np.arange(n_dim), type=pa.int64()),
        "prio": pa.array([f"p{i % 3}" for i in range(n_dim)]),
        "regionkey": pa.array(np.arange(n_dim, dtype=np.int64) % 7),
    })
    region = pa.table({
        "rk": pa.array(np.arange(7), type=pa.int64()),
        "rname": pa.array([f"region-{i}" for i in range(7)]),
    })
    return (_write(tmp_path, "fact", fact), _write(tmp_path, "dim", dim),
            _write(tmp_path, "region", region), fact)


Q_DIM_VALUED = """
    select mode,
           sum(case when prio = 'p0' then 1 else 0 end) as c0,
           sum(amount) as s
    from dim, fact
    where dk = fk
    group by mode
    order by mode
"""

Q_CHAINED = """
    select rname, count(*) as c, sum(amount * (1 + regionkey)) as s
    from dim, fact, region
    where dk = fk and rk = regionkey
    group by rname
    order by rname
"""

MAPPED_BATCHES = [("MappedScanExec", ("batches",), False)]


def test_dim_valued_aggregate_inputs(tmp_path):
    """q12 shape: a fact-column group key and an aggregate over a dim
    string."""
    fp, dp, _rp, _ = _star(tmp_path)
    jout, jst, pout, pst, routing = _run_both({"fact": fp, "dim": dp}, Q_DIM_VALUED)
    assert pst == jst == MAPPED_BATCHES
    assert routing["events"].get("mapped_rewrite") == 1
    _assert_same(jout, pout, 1e-4)


def test_chained_attachment_and_membership(tmp_path):
    """q7 shape: a second dim keyed on a column the first dim attached;
    fact rows with no dim match drop."""
    fp, dp, rp, fact = _star(tmp_path)
    jout, jst, pout, pst, _ = _run_both({"fact": fp, "dim": dp, "region": rp}, Q_CHAINED)
    assert pst == jst == MAPPED_BATCHES
    assert sum(pout.column("c").to_pylist()) < fact.num_rows
    _assert_same(jout, pout, 1e-4)


def test_composite_key_attachment(tmp_path):
    """q9 shape: a dim unique on a two-column key; out-of-range second
    components must not alias into other tuples."""
    rng = np.random.default_rng(3)
    n = 20_000
    fact = pa.table({
        "k1": pa.array(rng.integers(0, 40, n), type=pa.int64()),
        "k2": pa.array(rng.integers(0, 30, n), type=pa.int64()),
        "v": pa.array(rng.uniform(0, 10, n)),
    })
    rows = [(a, b) for a in range(40) for b in range(20)]
    dim = pa.table({
        "d1": pa.array([a for a, _ in rows], type=pa.int64()),
        "d2": pa.array([b for _, b in rows], type=pa.int64()),
        "cost": pa.array([float(a * 100 + b) for a, b in rows]),
    })
    paths = {"fact": _write(tmp_path, "fact", fact), "dim": _write(tmp_path, "dim", dim)}
    sql = ("select k1, sum(v * cost) as sc from dim, fact "
           "where d1 = k1 and d2 = k2 group by k1 order by k1")
    jout, jst, pout, pst, _ = _run_both(paths, sql)
    assert pst == jst == MAPPED_BATCHES
    _assert_same(jout, pout, 1e-4)


def test_duplicate_dim_keys_decline_correctly(tmp_path):
    """A non-unique dim key multiplies rows: both packages decline the
    mapped stage at prepare, the port records it as a host route with the
    reference's reason, and the host path gives the multiplied answer."""
    fact = pa.table({
        "fk": pa.array([1, 1, 2], type=pa.int64()),
        "mode": pa.array(["a", "a", "b"]),
        "amount": pa.array([1.0, 2.0, 4.0]),
    })
    dim = pa.table({"dk": pa.array([1, 1, 2], type=pa.int64()),
                    "prio": pa.array(["p0", "p1", "p0"])})
    paths = {"fact": _write(tmp_path, "fact", fact), "dim": _write(tmp_path, "dim", dim)}
    sql = ("select mode, count(*) as c, sum(amount) as s from dim, fact "
           "where dk = fk group by mode order by mode")
    jout, jst, pout, pst, routing = _run_both(paths, sql)
    assert pst == jst == []
    assert routing["routes"].get("host") == 1
    assert any("not unique" in r for r in routing["reasons"])
    assert pout.column("c").to_pylist() == jout.column("c").to_pylist() == [4, 1]
    assert pout.column("s").to_pylist() == jout.column("s").to_pylist()


def test_null_fact_keys_drop(tmp_path):
    fact = pa.table({
        "fk": pa.array([1, None, 2, None], type=pa.int64()),
        "mode": pa.array(["a", "a", "b", "b"]),
        "amount": pa.array([1.0, 2.0, 4.0, 8.0]),
    })
    dim = pa.table({"dk": pa.array([1, 2], type=pa.int64()),
                    "prio": pa.array(["p0", "p1"])})
    paths = {"fact": _write(tmp_path, "fact", fact), "dim": _write(tmp_path, "dim", dim)}
    sql = ("select mode, sum(amount) as s from dim, fact "
           "where dk = fk group by mode order by mode")
    jout, jst, pout, pst, _ = _run_both(paths, sql)
    assert pst == jst
    assert pout.column("s").to_pylist() == jout.column("s").to_pylist() == [1.0, 4.0]


def test_multifile_fact_as_build_side(tmp_path):
    """A multi-file fact on the build side and a single-file dim probe: the
    rewritten stage stripes every fact partition over the driven one."""
    rng = np.random.default_rng(9)
    fdir = tmp_path / "factdir"
    fdir.mkdir()
    total = 0
    for p in range(3):
        n = 5000 + p * 100
        pq.write_table(pa.table({
            "fk": pa.array(rng.integers(0, 200, n), type=pa.int64()),
            "mode": pa.array([f"m{i % 4}" for i in range(n)]),
            "amount": pa.array(rng.uniform(0, 10, n)),
        }), str(fdir / f"part-{p}.parquet"))
        total += n
    dim = pa.table({"dk": pa.array(np.arange(200), type=pa.int64()),
                    "prio": pa.array([f"p{i % 3}" for i in range(200)])})
    paths = {"fact": str(fdir), "dim": _write(tmp_path, "dim", dim)}
    sql = ("select mode, sum(case when prio = 'p1' then amount else 0 end) as s,"
           " count(*) as c from fact, dim where fk = dk "
           "group by mode order by mode")
    jout, jst, pout, pst, _ = _run_both(paths, sql)
    assert pst == jst and pst and pst[0][0] == "MappedScanExec"
    assert sum(pout.column("c").to_pylist()) == total
    _assert_same(jout, pout, 1e-4)


def test_float_min_equality_consumer_stays_exact(tmp_path):
    """q2 shape: a decorrelated MIN(float) equality-joined back against the
    source column; the device min must be the stored value bit for bit."""
    rng = np.random.default_rng(21)
    # 20 fact rows per key, as at 400 keys; the JAX reference unrolls its MIN
    # per group, so fewer keys compile faster
    n, nk = 2000, 100
    fact = pa.table({
        "fk": pa.array(rng.integers(0, nk, n), type=pa.int64()),
        "cost": pa.array(np.round(rng.uniform(1, 1000, n), 2)),
    })
    dim = pa.table({"dk": pa.array(np.arange(nk), type=pa.int64()),
                    "attr": pa.array([f"a{i % 9}" for i in range(nk)])})
    paths = {"fact": _write(tmp_path, "fact", fact), "dim": _write(tmp_path, "dim", dim)}
    sql = ("select fk, cost from dim, fact where dk = fk and cost = ("
           "  select min(cost) from dim d2, fact f2 "
           "  where d2.dk = f2.fk and f2.fk = fact.fk"
           ") order by fk")
    jout, jst, pout, pst, _ = _run_both(paths, sql)
    assert pst == jst
    assert pout.num_rows == jout.num_rows >= nk
    assert pout.column("cost").to_pylist() == jout.column("cost").to_pylist()


@pytest.mark.parametrize("op,expected,stages", [
    ("in", [1.0 + 2.0 + 8.0], MAPPED_BATCHES),
    # NOT IN keeps the null fact key's row in the anti-join output, and a
    # null in a device column declines the stage in both packages
    ("not in", [4.0 + 32.0], []),
])
def test_semi_and_anti_membership(tmp_path, op, expected, stages):
    """q4 shape: IN becomes a membership-only attachment; duplicate and null
    keys on the membership side are fine, null fact keys never match."""
    fact = pa.table({
        "fk": pa.array([1, 1, 2, 3, None, 5], type=pa.int64()),
        "mode": pa.array(["a", "b", "a", "b", "a", "b"]),
        "amount": pa.array([1.0, 2.0, 4.0, 8.0, 16.0, 32.0]),
    })
    sub = pa.table({"sk": pa.array([1, 1, 3, None], type=pa.int64()),
                    "x": pa.array([0.0, 1.0, 2.0, 3.0])})
    paths = {"fact": _write(tmp_path, "fact", fact), "sub": _write(tmp_path, "sub", sub)}
    sql = ("select sum(amount) as s from fact "
           f"where fk {op} (select sk from sub where sk is not null)")
    jout, jst, pout, pst, _ = _run_both(paths, sql)
    assert pst == jst == stages
    assert pout.column("s").to_pylist() == jout.column("s").to_pylist() == expected


def test_composite_semi_keys_with_nulls(tmp_path):
    """Composite EXISTS keys whose dim side has nulls in different rows:
    tuples stay row-aligned, only (1, 10) matches."""
    fact = pa.table({
        "k1": pa.array([1, 3, 7], type=pa.int64()),
        "k2": pa.array([10, 20, 30], type=pa.int64()),
        "amount": pa.array([1.0, 2.0, 4.0]),
    })
    sub = pa.table({"s1": pa.array([1, None, 3], type=pa.int64()),
                    "s2": pa.array([10, 20, None], type=pa.int64())})
    paths = {"fact": _write(tmp_path, "fact", fact), "sub": _write(tmp_path, "sub", sub)}
    sql = ("select sum(amount) as s from fact where exists ("
           "  select 1 from sub where s1 = k1 and s2 = k2)")
    jout, jst, pout, pst, _ = _run_both(paths, sql)
    assert pst == jst
    assert pout.column("s").to_pylist() == jout.column("s").to_pylist() == [1.0]


def test_ladder_step_aside_is_not_a_host_route(tmp_path):
    """The fact stage steps aside (the aggregate reads a dim column) and the
    mapped rewrite runs the aggregate on the device: the run records the
    "batches" route, the "mapped_rewrite" event, the step-aside reason and
    the stage's routing decision ("stage:device", as the JAX package records
    it), and no host route and no decline reason."""
    fp, dp, _rp, _ = _star(tmp_path)
    _, _, _, pst, routing = _run_both({"fact": fp, "dim": dp}, Q_DIM_VALUED)
    assert pst == MAPPED_BATCHES
    assert routing["routes"] == {"batches": 1}
    assert routing["reasons"] == {}
    assert routing["events"] == {"factagg.step_aside": 1, "mapped_rewrite": 1,
                                 "stage:device": 1}
    assert routing["step_asides"] == {
        "factagg admission: fact-side group key is not the join key": 1
    }


def test_ladder_final_verdict_is_the_only_host_route(tmp_path):
    """A shape no rung takes (MIN over a fact string column): the fact stage
    steps aside, the mapped rewrite's fused stage refuses the string input,
    and the run records exactly one host route with that final reason."""
    fp, dp, _rp, _ = _star(tmp_path)
    sql = ("select prio, min(mode) as m, sum(amount) as s from dim, fact "
           "where dk = fk group by prio order by prio")
    jout, jst, pout, pst, routing = _run_both({"fact": fp, "dim": dp}, sql)
    assert pst == jst == []
    assert routing["routes"] == {"host": 1}
    assert routing["reasons"] == {"stage build: string aggregate input": 1}
    assert routing["step_asides"] == {
        "factagg admission: string aggregate input": 1
    }
    _assert_same(jout, pout, 1e-4)


# ---------------------------------------------------------------------------
# the mapped fact's filtered batches merge up to the batch size before the
# extend: a selective filter below the join yields many small batches, and
# the "batches" route stages one entry per batch it is handed
# ---------------------------------------------------------------------------


def _grouped_fact(tmp_path, n=30_000, row_group=2_000, n_dim=800, seed=11,
                  null_every=0):
    """A fact of n / row_group row groups (one scan batch each) over `_star`'s
    dim; `null_every` > 0 makes every such row's join key null."""
    rng = np.random.default_rng(seed)
    fk = rng.integers(0, n_dim + 50, n)
    fact = pa.table({
        "fk": pa.array(fk, type=pa.int64(),
                       mask=(np.arange(n) % null_every == 0) if null_every else None),
        "mode": pa.array([f"m{i % 5}" for i in range(n)]),
        "amount": pa.array(rng.uniform(0, 100, n)),
    })
    p = tmp_path / "fact_rg.parquet"
    pq.write_table(fact, str(p), row_group_size=row_group)
    _fp, dp, _rp, _ = _star(tmp_path, n_dim=n_dim)
    return str(p), dp, fact


def _mapped_entries(cache):
    """{partition: [rows of each staged entry]} of the port's mapped
    "batches" stage."""
    out = {}
    for s in cache.values():
        if s in (None, False) or type(getattr(s, "scan", None)).__name__ != "MappedScanExec":
            continue
        for part, prep in s._device_cache.items():
            assert prep["kind"] == "batches"
            out[part] = [int(e["row_valid"].sum()) for e in prep["entries"]]
    return out


def _merge_counts(run):
    from ballista_tpu_torch.utils import tracing

    before = tracing.counters()
    out = run()
    after = tracing.counters()
    return out, {k: after.get(k, 0) - before.get(k, 0)
                 for k in ("mappedscan.batches_in", "mappedscan.batches_out")}


Q_FILTERED = """
    select mode,
           sum(case when prio = 'p0' then 1 else 0 end) as c0,
           count(*) as c,
           sum(amount) as s
    from dim, fact
    where dk = fk and amount < {cut}
    group by mode
    order by mode
"""


def test_filtered_fact_batches_merge_into_one_entry(tmp_path):
    """15 row groups and a filter that keeps about 3 % of the rows: the
    port's mapped stage stages one entry for its driven partition (the JAX
    package one per batch), and the answer is the JAX package's."""
    from ballista_tpu_torch.ops import kernels as tk

    fp, dp, fact = _grouped_fact(tmp_path)
    (jout, jst, pout, pst, routing), counts = _merge_counts(
        lambda: _run_both({"fact": fp, "dim": dp}, Q_FILTERED.format(cut=3)))
    assert pst == jst == MAPPED_BATCHES
    assert routing["routes"] == {"batches": 1}
    entries = _mapped_entries(tk._stage_cache)
    kept = int((fact.column("amount").to_numpy() < 3).sum())
    assert entries == {0: [kept]}
    assert counts == {"mappedscan.batches_in": 15, "mappedscan.batches_out": 1}
    _assert_same(jout, pout, 1e-4)


@pytest.mark.parametrize("batch_size,cut", [(1000, 20), (2500, 40), (777, 10)])
def test_merged_batches_stop_at_the_batch_size(tmp_path, batch_size, cut):
    """With `ballista.batch.size` below the filtered row count, the rows
    merge into ceil(rows / batch_size) entries, none past the batch size,
    all full but the last."""
    from ballista_tpu_torch.ops import kernels as tk

    fp, dp, fact = _grouped_fact(tmp_path)
    (jout, jst, pout, pst, _), counts = _merge_counts(
        lambda: _run_both({"fact": fp, "dim": dp}, Q_FILTERED.format(cut=cut),
                          {"ballista.batch.size": str(batch_size)}))
    assert pst == jst == MAPPED_BATCHES
    kept = int((fact.column("amount").to_numpy() < cut).sum())
    assert kept > batch_size
    entries = _mapped_entries(tk._stage_cache)
    n = -(-kept // batch_size)
    assert entries == {0: [batch_size] * (n - 1) + [kept - batch_size * (n - 1)]}
    assert counts["mappedscan.batches_out"] == n
    assert counts["mappedscan.batches_in"] > n
    _assert_same(jout, pout, 1e-4)


def test_filter_that_keeps_no_row_gives_the_empty_answer(tmp_path):
    fp, dp, _ = _grouped_fact(tmp_path)
    (jout, jst, pout, pst, _), counts = _merge_counts(
        lambda: _run_both({"fact": fp, "dim": dp}, Q_FILTERED.format(cut=-1)))
    assert pst == jst
    assert pout.num_rows == jout.num_rows == 0
    assert pout.column_names == jout.column_names
    assert counts["mappedscan.batches_out"] == 0


def test_merged_batch_past_max_groups_takes_the_sorted_route(tmp_path):
    """Each row group holds 500 distinct group keys, the merged batch about
    2,900: the port's stage raises past MAX_GROUPS (1024) and prepares the
    sorted layout, and gives the host path's answer (and the JAX package's,
    which stays on its per-batch route)."""
    from ballista_tpu_torch.ops import runtime as tr
    from ballista_tpu_torch.ops.stage import MAX_GROUPS

    rng = np.random.default_rng(5)
    n, n_dim = 6_000, 300
    fact = pa.table({
        "fk": pa.array(rng.integers(0, n_dim, n), type=pa.int64()),
        "g": pa.array(np.arange(n) // 2, type=pa.int64()),
        "amount": pa.array(rng.uniform(0, 100, n)),
    })
    fp = tmp_path / "fact_groups.parquet"
    pq.write_table(fact, str(fp), row_group_size=1_000)
    dim = pa.table({"dk": pa.array(np.arange(n_dim), type=pa.int64()),
                    "prio": pa.array([f"p{i % 3}" for i in range(n_dim)])})
    paths = {"fact": str(fp), "dim": _write(tmp_path, "dim", dim)}
    sql = ("select g, sum(case when prio = 'p0' then 1 else 0 end) as c0,"
           " sum(amount) as s from dim, fact where dk = fk and amount < 50"
           " group by g order by g")
    jout, jst, pout, pst, routing = _run_both(paths, sql)
    assert pout.num_rows > MAX_GROUPS
    assert pst == [("MappedScanExec", ("sorted",), False)]
    assert jst == MAPPED_BATCHES
    assert routing["routes"] == {"sorted": 1}
    hctx = ExecutionContext(BallistaConfig({"ballista.executor.backend": "cpu"}),
                            device="cpu")
    for name, p in paths.items():
        hctx.register_parquet(name, p)
    hout = hctx.sql(sql).collect()
    assert tr.routing_stats(reset=True)["routes"] == {}
    _assert_same(hout, pout, 1e-4)
    _assert_same(jout, pout, 1e-4)


@pytest.mark.parametrize("op", ["in", "exists"])
def test_semi_membership_over_merged_batches(tmp_path, op):
    """A membership-only attachment over merged batches: a fact row counts
    where its key is on the membership side, and a null fact key never
    matches; duplicate and null keys on the membership side change
    nothing."""
    fp, _dp, fact = _grouped_fact(tmp_path, null_every=7)
    sub = pa.table({"sk": pa.array(list(range(0, 850, 3)) * 2 + [None],
                                   type=pa.int64())})
    paths = {"fact": fp, "sub": _write(tmp_path, "sub", sub)}
    where = ("fk in (select sk from sub where sk is not null)" if op == "in"
             else "exists (select 1 from sub where sk = fk)")
    sql = ("select mode, count(*) as c, sum(amount) as s from fact "
           f"where amount < 5 and {where} group by mode order by mode")
    (jout, jst, pout, pst, _), counts = _merge_counts(lambda: _run_both(paths, sql))
    assert pst == jst == MAPPED_BATCHES
    assert counts == {"mappedscan.batches_in": 15, "mappedscan.batches_out": 1}
    fk = fact.column("fk").to_numpy(zero_copy_only=False)
    amount = fact.column("amount").to_numpy()
    keep = (amount < 5) & ~np.isnan(fk) & (np.nan_to_num(fk) % 3 == 0)
    modes = np.array(fact.column("mode").to_pylist())
    expect = [int((keep & (modes == m)).sum()) for m in sorted(set(modes[keep]))]
    assert pout.column("c").to_pylist() == expect
    _assert_same(jout, pout, 1e-4)


@pytest.mark.parametrize("sizes,target,expect", [
    ([0, 300, 800, 1000, 50], 1000, [1000, 1000, 150]),
    ([2500], 1000, [1000, 1000, 500]),
    ([1000, 1000], 1000, [1000, 1000]),
    ([10, 20], 1000, [30]),
    ([0, 0], 1000, []),
])
def test_coalesce_batches_carries_the_rows_past_a_full_batch(sizes, target, expect):
    """The port's coalescing (ballista_tpu_torch/physical/basic.py) keeps row
    order, and a batch of the target size that meets an empty buffer keeps
    its buffers."""
    from ballista_tpu_torch.physical.basic import coalesce_batches

    start = np.cumsum([0] + sizes)
    batches = [pa.record_batch({"v": pa.array(np.arange(a, a + k), type=pa.int64())})
               for a, k in zip(start, sizes)]
    out = list(coalesce_batches(iter(batches), target))
    assert [b.num_rows for b in out] == expect
    values = [v for b in out for v in b.column(0).to_pylist()]
    assert values == list(range(sum(sizes)))
    if sizes[0] == target:
        assert out[0].column(0).buffers()[1].address == batches[0].column(0).buffers()[1].address
