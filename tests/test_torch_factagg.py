"""The port's fact-side aggregate stage (ballista_tpu_torch/ops/factagg.py)
against the JAX package's (ballista_tpu/ops/factagg.py), on the same data:
the cases of tests/test_factagg.py, each run through the JAX "tpu" backend
(CPU JAX) and the port's "cuda" backend on CPU tensors (device="cpu"); a
tie at the candidate-pool edge that pins the lower-index rule; the
two-stage block top-k against the reference's closure; and the port's
step_topk / step_select run on the JAX stage's own prepared entry
(ops/state.py::prepared_from_reference).

Tolerances (tests/test_factagg.py:81-131): non-float columns equal, top-k
keys equal in order; f32 sums within rtol 1e-4 / atol 1e-3. On a carried
entry: int rows and selected ranks bit-equal, f32 rows within rtol 2e-5.
Both packages must build the same stage in the same mode (top-k, select or
secondary) or step aside alike.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import ExecutionContext

CPU = torch.device("cpu")
RTOL, ATOL = 1e-4, 1e-3
# the JAX reference runs need no AOT disk tier: exporting each traced
# program to .ballista_cache/aot was a large share of their time
JAX_REFERENCE = {"ballista.executor.backend": "tpu", "ballista.tpu.aot_cache": ""}


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
    tr.readback_stats(reset=True)  # the join site's share with it
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


def _run_both(paths, sql):
    """(JAX result, JAX stages, port result, port stages, port routing,
    the port stage's own readbacks: the totals less the dim side's device
    joins, the "join.*" keys of counters.readback)."""
    from ballista_tpu.ops import kernels as jk
    from ballista_tpu_torch.ops import kernels as tk
    from ballista_tpu_torch.ops import runtime as tr
    from ballista_tpu_torch.utils import counters

    _fresh()
    jctx = JaxContext(JaxConfig(JAX_REFERENCE))
    pctx = ExecutionContext(BallistaConfig({"ballista.executor.backend": "cuda"}),
                            device="cpu")
    for name, p in paths.items():
        jctx.register_parquet(name, p)
        pctx.register_parquet(name, p)
    jout = jctx.sql(sql).collect()
    pout = pctx.sql(sql).collect()
    reads = counters.readback.stats(reset=True)
    return (jout, _stages(jk._stage_cache), pout, _stages(tk._stage_cache),
            tr.routing_stats(reset=True),
            {k: reads[k] - reads.get(f"join.{k}", 0) for k in ("rows", "bytes", "readbacks")})


def _assert_same(jout, pout, rtol=RTOL, atol=ATOL):
    """Columns in order: non-floats equal, floats within tolerance."""
    assert pout.column_names == jout.column_names
    assert pout.num_rows == jout.num_rows
    for name, f in zip(jout.column_names, jout.schema):
        j, p = jout.column(name).to_pylist(), pout.column(name).to_pylist()
        if pa.types.is_floating(f.type):
            np.testing.assert_allclose(np.array(p, dtype=float), np.array(j, dtype=float),
                                       rtol=rtol, atol=atol, err_msg=name)
        else:
            assert p == j, name


def _write(d, name, table):
    p = d / f"{name}.parquet"
    pq.write_table(table, str(p))
    return str(p)


@pytest.fixture
def star(tmp_path):
    """tests/test_factagg.py's star: a fact table (20k rows, 3k distinct
    keys) and a dim table with a unique key."""
    rng = np.random.default_rng(5)
    nf, nk = 20_000, 3000
    fact = pa.table({
        "fk": pa.array(rng.integers(0, nk, nf), type=pa.int64()),
        "amount": pa.array(np.round(rng.uniform(1, 500, nf), 2)),
        "disc": pa.array(np.round(rng.uniform(0, 0.1, nf), 3)),
        "flag": pa.array(rng.integers(0, 2, nf), type=pa.int64()),
    })
    dim = pa.table({
        "dk": pa.array(np.arange(nk), type=pa.int64()),
        "attr": pa.array([f"grp-{i % 37}" for i in range(nk)]),
        "region": pa.array([f"r{i % 5}" for i in range(nk)]),
    })
    return {"fact": _write(tmp_path, "fact", fact), "dim": _write(tmp_path, "dim", dim)}


Q_TOPK = """
    select fk, sum(amount * (1 - disc)) as rev, attr
    from dim, fact
    where dk = fk and flag = 1
    group by fk, attr
    order by rev desc
    limit 15
"""

Q_FULL = """
    select fk, sum(amount) as s, count(amount) as c, avg(amount) as a, attr
    from dim, fact
    where dk = fk
    group by fk, attr
    order by fk
"""


def test_topk_pushdown(star):
    jout, jst, pout, pst, routing, reads = _run_both(star, Q_TOPK)
    assert pst == jst == [("fact", "topk")]
    assert routing["routes"] == {"fact_topk": 1}
    # one readback of the candidate pool (TOPK_POOL columns), not 3k groups
    assert reads["readbacks"] == 1 and reads["rows"] == 64
    _assert_same(jout, pout)


def test_full_select(star):
    jout, jst, pout, pst, routing, _ = _run_both(star, Q_FULL)
    assert pst == jst == [("fact", "select")]
    assert routing["routes"] == {"fact_select": 1}
    assert pout.num_rows > 2900
    _assert_same(jout, pout)


def test_duplicate_dim_keys_decline(star, tmp_path):
    """A dim side with duplicate join keys multiplies fact rows: the fact
    stage declines with the reference's reason and the host join answers."""
    dim2 = pa.table({
        "dk": pa.array(np.concatenate([np.arange(3000), [0, 1, 2]]), type=pa.int64()),
        "attr": pa.array([f"a{i}" for i in range(3003)]),
    })
    paths = {**star, "dim2": _write(tmp_path, "dim2", dim2)}
    sql = ("select fk, sum(amount) as s, attr from dim2, fact "
           "where dk = fk group by fk, attr order by fk, attr")
    jout, jst, pout, pst, routing, _ = _run_both(paths, sql)
    assert pst == jst == []
    assert routing["routes"] == {"host": 1}
    assert any("dim join key not unique" in r for r in routing["reasons"])
    _assert_same(jout, pout)


def test_no_match_keys_empty_result(star):
    sql = ("select fk, sum(amount) as s from dim, fact "
           "where dk = fk and dk > 100000 group by fk")
    jout, jst, pout, pst, routing, _ = _run_both(star, sql)
    assert pst == jst == [("fact", "select")]
    assert pout.num_rows == jout.num_rows == 0
    assert "host" not in routing["routes"]


def test_topk_over_integer_sum(star):
    """ORDER BY SUM(int column) LIMIT k: the int32 score row ranks as f32."""
    sql = ("select fk, sum(flag) as nf from dim, fact "
           "where dk = fk group by fk order by nf desc limit 10")
    jout, jst, pout, pst, _, _ = _run_both(star, sql)
    assert pst == jst == [("fact", "topk")]
    assert pout.column("nf").to_pylist() == jout.column("nf").to_pylist()


def _find_agg(plan):
    stack = [plan]
    while stack:
        node = stack.pop()
        if type(node).__name__ == "HashAggregateExec" and node.mode.value in ("single", "partial"):
            return node
        stack.extend(node.children())
    raise AssertionError("no partial/single aggregate in the plan")


def test_topk_int_sum_f32_collapse_boundary(tmp_path):
    """Integer SUM scores rank as f32; above 2^24 distinct sums collapse into
    false ties. A collapse run across the pool edge makes both packages'
    stages raise "top-k tie at candidate boundary", and end to end the host
    plan answers exactly."""
    from ballista_tpu.ops.factagg import FactAggregateStage as JaxFact
    from ballista_tpu.ops.runtime import UnsupportedOnDevice as JaxUnsupported
    from ballista_tpu.physical.plan import TaskContext as JaxTaskContext
    from ballista_tpu_torch.ops.factagg import FactAggregateStage
    from ballista_tpu_torch.ops.runtime import UnsupportedOnDevice
    from ballista_tpu_torch.physical.plan import TaskContext

    base = 1 << 25
    G = 4000
    sums = np.full(G, base, dtype=np.int64)
    sums[:5] = base + 1000 * (np.arange(5) + 1)
    sums[G - 1] = base + 1
    rng = np.random.default_rng(0)
    fact = pa.table({
        "fk": pa.array(np.arange(G), type=pa.int64()),
        "amount": pa.array(sums, type=pa.int64()),
        "pad1": pa.array(rng.uniform(0, 1, G)),
        "pad2": pa.array(rng.uniform(0, 1, G)),
        "pad3": pa.array(rng.uniform(0, 1, G)),
    })
    dim = pa.table({"dk": pa.array(np.arange(G), type=pa.int64()),
                    "attr": pa.array([f"a{i}" for i in range(G)])})
    paths = {"fact": _write(tmp_path, "fact", fact), "dim": _write(tmp_path, "dim", dim)}
    sql = ("select fk, sum(amount) as s, attr from dim, fact "
           "where dk = fk group by fk, attr order by s desc limit 10")
    _fresh()
    jctx = JaxContext(JaxConfig(JAX_REFERENCE))
    pctx = ExecutionContext(BallistaConfig({}), device="cpu")
    for name, p in paths.items():
        jctx.register_parquet(name, p)
        pctx.register_parquet(name, p)
    jstage = JaxFact(_find_agg(jctx.create_physical_plan(jctx.sql(sql).logical_plan())))
    pstage = FactAggregateStage(_find_agg(pctx.create_physical_plan(pctx.sql(sql).logical_plan())))
    assert jstage.topk is not None and pstage.topk is not None
    with pytest.raises(JaxUnsupported, match="tie at candidate boundary"):
        jstage.run(0, JaxTaskContext(config=jctx.config, work_dir=str(tmp_path), job_id="t"))
    with pytest.raises(UnsupportedOnDevice, match="tie at candidate boundary"):
        pstage.run(0, TaskContext(config=pctx.config, device=CPU))
    jout, _, pout, _, routing, _ = _run_both(paths, sql)
    assert routing["routes"] == {"host": 1}
    assert any("tie at candidate boundary" in r for r in routing["reasons"])
    assert pout.column("s").to_pylist() == jout.column("s").to_pylist()
    assert (base + 1) in pout.column("s").to_pylist()


def test_topk_tie_at_pool_edge_takes_lower_index(tmp_path):
    """Many groups tie at the k-th score past the candidate-pool edge
    (a non-strict f32 score, so no fallback): the pool keeps the
    lowest-ranked tied groups, as jax.lax.top_k does, and both packages
    return the same keys in the same order."""
    G, k = 3000, 8
    fk = np.repeat(np.arange(G), 2)
    amount = np.full(2 * G, 50.0)  # every group sums to exactly 100.0
    top = np.array([17, 400, 1234, 2999])
    amount[2 * top] = 50.0 + 10.0 * (np.arange(len(top)) + 1)  # four distinct leaders
    rng = np.random.default_rng(1)
    perm = rng.permutation(2 * G)  # fact rows out of key order
    fact = pa.table({
        "fk": pa.array(fk[perm], type=pa.int64()),
        "amount": pa.array(amount[perm]),
        "pad1": pa.array(rng.uniform(0, 1, 2 * G)),
        "pad2": pa.array(rng.uniform(0, 1, 2 * G)),
    })
    dim = pa.table({"dk": pa.array(np.arange(G), type=pa.int64()),
                    "attr": pa.array([f"a{i}" for i in range(G)])})
    paths = {"fact": _write(tmp_path, "fact", fact), "dim": _write(tmp_path, "dim", dim)}
    sql = ("select fk, sum(amount) as s, attr from dim, fact "
           f"where dk = fk group by fk, attr order by s desc limit {k}")
    jout, jst, pout, pst, routing, reads = _run_both(paths, sql)
    assert pst == jst == [("fact", "topk")]
    assert routing["routes"] == {"fact_topk": 1} and reads["rows"] == 64
    got = pout.column("fk").to_pylist()
    assert got == jout.column("fk").to_pylist()
    assert pout.column("s").to_pylist() == jout.column("s").to_pylist()
    # the leaders in score order, then the tied groups of lowest rank (the
    # stage's group order, rank_keys): the pool's lower-index rule
    from ballista_tpu_torch.ops import kernels as tk

    (stage,) = [s for s in tk._stage_cache.values() if s]
    rank_keys = stage._prepared[0]["rank_keys"].tolist()
    assert got[:4] == list(top[::-1])
    tied = [key for key in rank_keys if key not in set(top.tolist())]
    assert got[4:] == tied[: k - 4]


def test_nested_dim_joins_group_by_dim_only(star, tmp_path):
    """q10 shape: two dim joins above the fact, grouped by a dim attribute
    only. The fact stage admits it without a fused top-k, so the ladder
    prefers the mapped rewrite whose fused top-k ranks the output groups."""
    rng = np.random.default_rng(9)
    dimA = pa.table({"dk": pa.array(np.arange(3000), type=pa.int64()),
                     "ck": pa.array(rng.integers(0, 50, 3000), type=pa.int64())})
    dimB = pa.table({"ck2": pa.array(np.arange(50), type=pa.int64()),
                     "cattr": pa.array([f"c{i}" for i in range(50)])})
    paths = {**star, "dimA": _write(tmp_path, "dimA", dimA),
             "dimB": _write(tmp_path, "dimB", dimB)}
    sql = """
        select cattr, sum(amount) as s, count(*) as n
        from dimB, dimA, fact
        where ck2 = ck and dk = fk
        group by cattr
        order by s desc
        limit 12
    """
    jout, jst, pout, pst, routing, reads = _run_both(paths, sql)
    assert pst == jst
    assert len(pst) == 1 and pst[0][0] == "MappedScanExec" and pst[0][2]
    assert routing["events"].get("mapped_rewrite") == 1
    assert reads["rows"] == 12
    _assert_same(jout, pout, rtol=1e-4, atol=0.0)


def test_planner_annotates_topk(star):
    from ballista_tpu_torch.physical.aggregate import HashAggregateExec

    ctx = ExecutionContext(BallistaConfig({"ballista.executor.backend": "cpu"}), device="cpu")
    for name, p in star.items():
        ctx.register_parquet(name, p)
    agg = _find_agg(ctx.create_physical_plan(ctx.sql(Q_TOPK).logical_plan()))
    assert isinstance(agg, HashAggregateExec)
    assert getattr(agg, "_topk_pushdown", None) == {
        "agg_index": 0, "descending": True, "k": 15, "strict": False,
        "keys": [{"agg_index": 0, "descending": True}], "covered": True,
    }


@pytest.fixture
def coupled_star(tmp_path):
    """q5-shaped schema: the fact joins a secondary dim on a fact column, with
    an attribute coupling between the primary and the secondary dim."""
    rng = np.random.default_rng(11)
    n_orders, n_supp, nf = 900, 50, 24_000
    tables = {
        "orders": pa.table({
            "o_key": pa.array(np.arange(n_orders), type=pa.int64()),
            "o_flag": pa.array(rng.integers(0, 2, n_orders), type=pa.int64()),
            "c_nat": pa.array(rng.integers(0, 8, n_orders), type=pa.int64()),
        }),
        "supplier": pa.table({
            "s_key": pa.array(np.arange(n_supp), type=pa.int64()),
            "s_nat": pa.array(rng.integers(0, 8, n_supp), type=pa.int64()),
        }),
        "nation": pa.table({
            "nat_key": pa.array(np.arange(8), type=pa.int64()),
            "nat_name": pa.array([f"nation-{i}" for i in range(8)]),
            "nat_region": pa.array([i % 2 for i in range(8)], type=pa.int64()),
        }),
        "fact": pa.table({
            "f_okey": pa.array(rng.integers(0, n_orders, nf), type=pa.int64()),
            "f_skey": pa.array(rng.integers(0, n_supp, nf), type=pa.int64()),
            "amount": pa.array(np.round(rng.uniform(1, 100, nf), 2)),
        }),
    }
    return {name: _write(tmp_path, name, t) for name, t in tables.items()}


Q_COUPLED = """
    select nat_name, sum(amount) as rev
    from orders, fact, supplier, nation
    where o_key = f_okey and f_skey = s_key and c_nat = s_nat
      and s_nat = nat_key and nat_region = 1 and o_flag = 1
    group by nat_name
    order by nat_name
"""


def test_coupled_secondary_dim(coupled_star):
    jout, jst, pout, pst, routing, reads = _run_both(coupled_star, Q_COUPLED)
    assert pst == jst == [("fact", "secondary")]
    assert routing["routes"] == {"fact_secondary": 1}
    assert reads["readbacks"] == 1
    _assert_same(jout, pout)


def test_coupled_secondary_impure_filter_steps_aside(coupled_star):
    """A secondary-side filter that is not a pure function of the coupling
    attribute (here on s_key) would invalidate the static map: the filter
    lands on the secondary base, the fact stage steps aside with the
    reference's reason, and both packages run the mapped rewrite."""
    sql = Q_COUPLED.replace("and o_flag = 1", "and o_flag = 1 and s_key < 25")
    jout, jst, pout, pst, routing, _ = _run_both(coupled_star, sql)
    assert pst == jst and pst[0][0] == "MappedScanExec"
    assert "host" not in routing["routes"]
    assert routing["step_asides"] == {"factagg admission: filtered secondary base": 1}
    _assert_same(jout, pout)


def test_semi_join_folds_into_membership(tmp_path):
    """q18 shape: a SEMI join above the fact's inner join folds whole into
    the dim-plan membership."""
    rng = np.random.default_rng(17)
    # 30 fact rows per order, as at 600 orders; the JAX reference unrolls its
    # inner aggregate per group, so fewer orders compile faster
    n_orders, nf = 150, 4_500
    orders = pa.table({"o_key": pa.array(np.arange(n_orders), type=pa.int64()),
                       "o_name": pa.array([f"o{i}" for i in range(n_orders)])})
    fact = pa.table({"f_okey": pa.array(rng.integers(0, n_orders, nf), type=pa.int64()),
                     "qty": pa.array(np.round(rng.uniform(1, 50, nf), 2))})
    paths = {"fact": _write(tmp_path, "fact", fact),
             "orders": _write(tmp_path, "orders", orders)}
    sql = """
        select o_name, o_key, sum(qty) as s
        from orders, fact
        where o_key = f_okey
          and o_key in (select f_okey from fact group by f_okey
                        having sum(qty) > 800)
        group by o_name, o_key
        order by o_key
    """
    jout, jst, pout, pst, routing, _ = _run_both(paths, sql)
    assert pst == jst
    assert ("fact", "select") in pst
    assert "host" not in routing["routes"]
    assert pout.num_rows > 0
    _assert_same(jout, pout)


@pytest.mark.parametrize("dim,probe_parts", [("cust", 1), ("cust8", 8)])
def test_fact_partitions_differ_from_driven_partitions(tmp_path, dim, probe_parts):
    """A multi-partition fact on the build side: the fact stage stripes every
    fact file over the driven partitions (reading only file p would be a
    silent 1/N of the data), for both the select and the top-k mode."""
    from ballista_tpu_torch.ops import kernels as tk
    from ballista_tpu_torch.ops.factagg import FactAggregateStage

    rng = np.random.default_rng(11)
    n = 40_000
    (tmp_path / "sales").mkdir()
    for p in range(4):
        pq.write_table(pa.table({"cust": rng.integers(0, 500, n // 4),
                                 "amount": rng.uniform(1, 1000, n // 4)}),
                       str(tmp_path / "sales" / f"part-{p}.parquet"))
    (tmp_path / dim).mkdir()
    ids = pa.table({"c_id": np.arange(500)})
    if probe_parts == 1:
        pq.write_table(ids, str(tmp_path / dim / "p0.parquet"))
    else:
        for p in range(probe_parts):
            pq.write_table(ids.slice(p * 63, 63), str(tmp_path / dim / f"part-{p}.parquet"))
    paths = {"sales": str(tmp_path / "sales"), dim: str(tmp_path / dim)}
    for sql in (
        f"select cust, sum(amount) as rev from sales, {dim} "
        "where c_id = cust group by cust order by cust",
        f"select cust, sum(amount) as rev from sales, {dim} "
        "where c_id = cust group by cust order by rev desc limit 5",
    ):
        jout, jst, pout, pst, routing, _ = _run_both(paths, sql)
        assert pst == jst
        assert "host" not in routing["routes"]
        ran = [s for s in tk._stage_cache.values()
               if isinstance(s, FactAggregateStage) and s._prepared]
        assert ran and all(s.inner.scan_stride is not None for s in ran)
        _assert_same(jout, pout)


def test_date_minmax_through_factagg(tmp_path):
    """MIN/MAX over a fact-side date32 column through the fact stage."""
    rng = np.random.default_rng(8)
    nf, nk = 20_000, 2000
    fact = pa.table({
        "fk": pa.array(rng.integers(0, nk, nf), type=pa.int64()),
        "amount": pa.array(rng.uniform(1, 100, nf)),
        "ship": pa.array(rng.integers(8000, 12000, nf), type=pa.int32()).cast(pa.date32()),
    })
    dim = pa.table({"dk": pa.array(np.arange(nk), type=pa.int64()),
                    "attr": pa.array([f"a{i % 11}" for i in range(nk)])})
    paths = {"fact": _write(tmp_path, "fact", fact), "dim": _write(tmp_path, "dim", dim)}
    sql = ("select fk, min(ship) as mn, max(ship) as mx, attr "
           "from dim, fact where dk = fk group by fk, attr order by fk")
    jout, jst, pout, pst, _, _ = _run_both(paths, sql)
    assert pst == jst == [("fact", "select")]
    _assert_same(jout, pout)


def _reference_two_stage(masked, kk):
    """The JAX package's two_stage_topk (ballista_tpu/ops/factagg.py:726-744)
    as a function of its own."""
    import jax
    import jax.numpy as jnp

    n = masked.shape[0]
    B = 128
    if n < kk * B:
        return jax.lax.top_k(masked, kk)[1]
    npad = -(-n // B) * B
    m2 = jnp.pad(masked, (0, npad - n), constant_values=-jnp.inf).reshape(-1, B)
    _, bidx = jax.lax.top_k(jnp.max(m2, axis=1), kk)
    _, ci = jax.lax.top_k(m2[bidx].reshape(-1), kk)
    return bidx[ci // B] * B + ci % B


@pytest.mark.parametrize("n,kk,levels", [
    (500, 64, 7),        # one stage: n < kk * 128
    (20_000, 64, 5),     # block maxima, then the candidates of the best blocks
    (40_000, 80, 1000),  # few ties
])
def test_two_stage_top_k_matches_reference(n, kk, levels):
    """Same candidate pool in the same order, ties and -inf included."""
    from ballista_tpu_torch.ops.factagg import two_stage_top_k

    rng = np.random.default_rng(n + kk)
    x = rng.integers(0, levels, n).astype(np.float32)
    x[rng.random(n) < 0.3] = -np.inf
    got = two_stage_top_k(torch.from_numpy(x), kk).numpy()
    want = np.asarray(_reference_two_stage(x, kk))
    assert got.tolist() == want.tolist()


# -- the port's fact steps on the JAX stage's own prepared entry -----------

def _to_numpy(obj):
    """Device arrays of a JAX prepared entry -> numpy (layout objects, Arrow
    key values and plain scalars pass through)."""
    import jax

    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_to_numpy(v) for v in obj)
    if isinstance(obj, list):
        return [_to_numpy(v) for v in obj]
    if isinstance(obj, jax.Array):
        return np.asarray(obj)
    return obj


Q_CARRY_TOPK = """
    select fk, sum(amount * (1 - disc)) as rev, sum(flag) as nf, count(*) as n,
           min(amount) as mn, attr
    from dim, fact
    where dk = fk and disc < 0.08
    group by fk, attr
    order by rev desc
    limit 15
"""


def _both_stages(star, sql):
    """(JAX FactAggregateStage after one run, its prepared entry as numpy,
    the port's FactAggregateStage of the same plan)."""
    from ballista_tpu.ops.factagg import FactAggregateStage as JaxFact
    from ballista_tpu.physical.plan import TaskContext as JaxTaskContext
    from ballista_tpu_torch.ops.factagg import FactAggregateStage

    _fresh()
    jctx = JaxContext(JaxConfig(JAX_REFERENCE))
    pctx = ExecutionContext(BallistaConfig({}), device="cpu")
    for name, p in star.items():
        jctx.register_parquet(name, p)
        pctx.register_parquet(name, p)
    jstage = JaxFact(_find_agg(jctx.create_physical_plan(jctx.sql(sql).logical_plan())))
    jstage.run(0, JaxTaskContext(config=jctx.config))
    pstage = FactAggregateStage(_find_agg(pctx.create_physical_plan(pctx.sql(sql).logical_plan())))
    assert pstage.inner._int_rows == jstage.inner._int_rows
    return jstage, _to_numpy(jstage._prepared[0]), pstage


def _assert_rows(prows, jrows, int_rows):
    for i, (p, j, is_int) in enumerate(zip(prows, jrows, int_rows)):
        if is_int:
            assert p.tolist() == j.tolist(), f"int row {i}"
        else:
            np.testing.assert_allclose(p, j, rtol=2e-5, err_msg=f"f32 row {i}")


def test_step_topk_on_reference_entry(star):
    """step_topk over the JAX stage's own entry and dim side: the pool's
    ranks and validity bit-equal, int rows bit-equal, f32 rows within
    rtol 2e-5 of the JAX step's decoded output."""
    import jax.numpy as jnp

    from ballista_tpu_torch.ops.runtime import upload
    from ballista_tpu_torch.ops.state import prepared_from_reference

    jstage, entry, pstage = _both_stages(star, Q_CARRY_TOPK)
    assert jstage.topk is not None and pstage.topk is not None
    carried = prepared_from_reference(entry, CPU)
    assert carried["rank_keys"].tolist() == entry["rank_keys"].tolist()
    dim = jstage._dim_cache
    member_ranks, dim_rows = pstage.member_ranks(carried, dim)
    member = np.zeros(entry["n_groups"], dtype=bool)
    member[member_ranks] = True
    bits = np.packbits(member, bitorder="little")
    # the port's step takes the dim row per rank (-1: not a member)
    rank_to_dim = np.full(entry["n_groups"], -1, dtype=np.int64)
    rank_to_dim[member_ranks] = dim_rows

    jaux = [jnp.asarray(a) for a in jstage.inner.compiler.build_aux()]
    jpacked = np.asarray(jstage._fact_step(
        entry["layout"].L1, entry["cols"], jaux, entry["clen"], jnp.asarray(bits)
    ))
    jidx = jpacked[-3].astype(np.int64) * 65536 + jpacked[-2].astype(np.int64)
    jvalid = jpacked[-1] > 0
    jrows = jstage._decode(jpacked[:-4])

    paux = [upload(np.asarray(a), CPU) for a in pstage.inner.compiler.build_aux()]
    ppacked = pstage.step_topk(carried, paux, torch.from_numpy(rank_to_dim)).numpy()
    n_rows = len(pstage.inner._int_rows)
    assert ppacked.shape == (n_rows + 4, pstage.pool_size(entry["n_groups"]))
    assert ppacked[n_rows + 1].tolist() == jidx.tolist()
    assert (ppacked[n_rows + 2] > 0).tolist() == jvalid.tolist()
    assert ppacked[n_rows + 3].tolist() == rank_to_dim[jidx].tolist()
    np.testing.assert_allclose(ppacked[n_rows].view(np.float32), jpacked[-4], rtol=2e-5)
    _assert_rows(pstage._decode(ppacked[:n_rows]), jrows, pstage.inner._int_rows)


def test_step_select_on_reference_entry(star):
    """step_select over the JAX stage's own entry at its member ranks: int
    rows bit-equal, f32 rows within rtol 2e-5."""
    import jax.numpy as jnp

    from ballista_tpu.ops.runtime import bucket_rows, pad_to
    from ballista_tpu_torch.ops.runtime import upload
    from ballista_tpu_torch.ops.state import prepared_from_reference

    sql = Q_CARRY_TOPK.replace("order by rev desc\n    limit 15", "")
    jstage, entry, pstage = _both_stages(star, sql)
    assert jstage.topk is None and pstage.topk is None
    carried = prepared_from_reference(entry, CPU)
    positions, _ = pstage.member_ranks(carried, jstage._dim_cache)
    assert len(positions) > 2000

    jaux = [jnp.asarray(a) for a in jstage.inner.compiler.build_aux()]
    pos_pad = pad_to(positions.astype(np.int32), bucket_rows(len(positions), 16), 0)
    jsel = np.asarray(jstage._fact_step(
        entry["layout"].L1, entry["cols"], jaux, entry["clen"], jnp.asarray(pos_pad)
    ))[:, : len(positions)]

    paux = [upload(np.asarray(a), CPU) for a in pstage.inner.compiler.build_aux()]
    psel = pstage.step_select(carried, paux, torch.from_numpy(positions.astype(np.int64)))
    _assert_rows(pstage._decode(psel.numpy()), jstage._decode(jsel), pstage.inner._int_rows)


def test_secondary_entry_carries_derived_tiles(coupled_star):
    """A q5-shaped stage's entry carries its derived secondary-attribute
    tiles, and the port's run over the carried entry gives the JAX stage's
    partial table."""
    from ballista_tpu.ops.factagg import FactAggregateStage as JaxFact
    from ballista_tpu.physical.plan import TaskContext as JaxTaskContext
    from ballista_tpu_torch.ops.factagg import FactAggregateStage
    from ballista_tpu_torch.ops.state import prepared_from_reference
    from ballista_tpu_torch.physical.plan import TaskContext

    _fresh()
    jctx = JaxContext(JaxConfig(JAX_REFERENCE))
    pctx = ExecutionContext(BallistaConfig({}), device="cpu")
    for name, p in coupled_star.items():
        jctx.register_parquet(name, p)
        pctx.register_parquet(name, p)
    jstage = JaxFact(_find_agg(jctx.create_physical_plan(jctx.sql(Q_COUPLED).logical_plan())))
    jtable = jstage.run(0, JaxTaskContext(config=jctx.config))
    entry = _to_numpy(jstage._prepared[0])
    assert set(entry["derived"]) == {"sec_attr"}
    pstage = FactAggregateStage(_find_agg(pctx.create_physical_plan(pctx.sql(Q_COUPLED).logical_plan())))
    assert pstage.secondary is not None
    carried = prepared_from_reference(entry, CPU)
    assert carried["derived"]["sec_attr"].shape == tuple(entry["derived"]["sec_attr"].shape)
    # the carried entry stands in for the port's own prepare
    pstage._prepared[0] = carried
    pstage._sec_map = jstage._sec_map
    ptable = pstage.run(0, TaskContext(config=pctx.config, device=CPU))
    assert ptable.schema == jtable.schema
    _assert_same(jtable.sort_by("nat_name"), ptable.sort_by("nat_name"))


# -- the rank match on the stage's device against the host search ------------

def _keys(case, rng):
    """(fact rank keys, dim keys in table order) for one parity case."""
    big = rng.choice(np.arange(-(1 << 40), 1 << 40, 7919), 6000, replace=False)
    if case == "int64_random":
        return big[:4000], rng.permutation(np.concatenate([big[1000:3000], big[4000:5000]]))
    if case == "int32_fact_int64_dim":
        keys = rng.choice(1 << 30, 3000, replace=False)
        return keys.astype(np.int32), rng.permutation(keys[::3]).astype(np.int64)
    if case == "negative":
        keys = rng.permutation(np.arange(-2500, 2500))
        return keys[:3000], rng.permutation(keys[1500:4500])
    if case == "empty_dim":
        return big[:4000], np.array([], dtype=np.int64)
    if case == "no_match":
        return big[:3000], big[3000:]
    assert case == "all_match"
    return big[:3000], rng.permutation(big)


@pytest.mark.parametrize("case", ["int64_random", "int32_fact_int64_dim", "negative",
                                  "empty_dim", "no_match", "all_match"])
def test_device_match_is_bit_equal_to_host_search(case):
    """match_ranks on tensors against member_ranks (the host search) for the
    match mask and the dim row per rank, and against the secondary stage's
    former host search (rank keys into the sorted dim keys) for the
    coupling value per rank, -1 where unmatched."""
    from ballista_tpu_torch.ops.factagg import FactAggregateStage, int64_keys, match_ranks

    rng = np.random.default_rng(sum(map(ord, case)))
    rank_keys, dim_keys = _keys(case, rng)
    order = np.argsort(dim_keys, kind="stable")
    dim = {"keys_sorted": dim_keys[order], "order": order}
    p = rng.integers(0, 25, len(dim_keys)).astype(np.int64)  # coupling column

    ranks, dim_rows = FactAggregateStage.member_ranks(None, {"rank_keys": rank_keys}, dim)
    want_mask = np.zeros(len(rank_keys), dtype=bool)
    want_mask[ranks] = True
    want_row = np.full(len(rank_keys), -1, dtype=np.int64)
    want_row[ranks] = dim_rows
    want_p = np.full(len(rank_keys), -1, dtype=np.int32)
    if len(dim_keys):
        ks = dim["keys_sorted"]
        pos = np.clip(np.searchsorted(ks, rank_keys), 0, len(ks) - 1)
        want_p = np.where(ks[pos] == rank_keys, p[order][pos], -1).astype(np.int32)

    matched, pos, dim_row = match_ranks(
        torch.from_numpy(int64_keys(rank_keys)),
        torch.from_numpy(int64_keys(dim["keys_sorted"])),
        torch.from_numpy(order.astype(np.int64)),
    )
    # the secondary stage returns before its match on an empty dim side
    p_rank = (torch.where(matched, torch.from_numpy(p[order])[pos], -1).to(torch.int32)
              if len(dim_keys) else torch.full(matched.shape, -1, dtype=torch.int32))
    assert matched.numpy().tolist() == want_mask.tolist()
    assert dim_row.numpy().tolist() == want_row.tolist()
    assert p_rank.numpy().tolist() == want_p.tolist()
    members = int(want_mask.sum())  # each case holds what its name says
    if case in ("empty_dim", "no_match"):
        assert members == 0
    elif case == "all_match":
        assert members == len(rank_keys)
    else:
        assert 0 < members < len(rank_keys)


@pytest.mark.parametrize("values,admitted", [
    (np.array([3, -1], dtype=np.int64), True),
    (np.array([3, 1], dtype=np.int32), True),
    (np.array([3, 1], dtype=np.uint32), True),
    (np.array([3, 1], dtype=np.uint64), False),
    (np.array(["a", "b"], dtype=object), False),
    (np.array([3.0, 1.0]), False),
    (np.array(["2020-01-01", "2021-01-01"], dtype="datetime64[D]"), False),
])
def test_int64_keys_admits_integers_int64_orders(values, admitted):
    from ballista_tpu_torch.ops.factagg import int64_keys

    out = int64_keys(values)
    assert (out is not None) == admitted
    if admitted:
        assert out.dtype == np.int64 and out.tolist() == values.tolist()


def _port_stage(paths, sql):
    """The port's FactAggregateStage of the query's plan, and a task context."""
    from ballista_tpu_torch.ops.factagg import FactAggregateStage
    from ballista_tpu_torch.physical.plan import TaskContext

    _fresh()
    pctx = ExecutionContext(BallistaConfig({}), device="cpu")
    for name, p in paths.items():
        pctx.register_parquet(name, p)
    stage = FactAggregateStage(_find_agg(pctx.create_physical_plan(pctx.sql(sql).logical_plan())))
    return stage, TaskContext(config=pctx.config, device=CPU)


def _match_counts():
    from ballista_tpu_torch.utils import tracing

    c = tracing.counters()
    return c.get("factagg.rank_match.device", 0), c.get("factagg.rank_match.host", 0)


@pytest.mark.parametrize("fixture,sql,route", [
    ("star", Q_TOPK, "fact_topk"),
    ("star", Q_FULL, "fact_select"),
    ("coupled_star", Q_COUPLED, "fact_secondary"),
], ids=["topk", "select", "secondary"])
def test_device_match_equals_host_search_through_the_stage(request, fixture, sql, route):
    """One partition run with the rank keys resident (the device match),
    then one with them taken away (the host search): equal partial tables,
    one count on each counter."""
    stage, tctx = _port_stage(request.getfixturevalue(fixture), sql)
    assert stage.route == route
    dev0, host0 = _match_counts()
    on_device = stage.run(0, tctx)
    ent = stage._prepared[0]
    assert ent["rank_keys_dev"].dtype == torch.int64
    assert ent["rank_keys_dev"].tolist() == ent["rank_keys"].tolist()
    assert "rank_order" not in ent  # the host search's sort, computed only for it
    assert _match_counts() == (dev0 + 1, host0)
    del ent["rank_keys_dev"]
    on_host = stage.run(0, tctx)
    assert _match_counts() == (dev0 + 1, host0 + 1)
    assert on_device.num_rows > 0
    assert on_device.equals(on_host)


@pytest.mark.parametrize("limit", ["", "order by s desc limit 10"], ids=["select", "topk"])
def test_string_keys_take_the_host_search(tmp_path, limit):
    """String join keys are not matched on the device: the host search
    runs, counted once, and the answer is the JAX package's."""
    rng = np.random.default_rng(23)
    nf, nk = 6000, 800
    fact = pa.table({"fk": pa.array([f"k{v:04d}" for v in rng.integers(0, nk, nf)]),
                     "amount": pa.array(np.round(rng.uniform(1, 100, nf), 2))})
    dim = pa.table({"dk": pa.array([f"k{i:04d}" for i in range(0, nk, 2)]),
                    "attr": pa.array([f"a{i % 13}" for i in range(0, nk, 2)])})
    paths = {"fact": _write(tmp_path, "fact", fact), "dim": _write(tmp_path, "dim", dim)}
    sql = ("select fk, sum(amount) as s, attr from dim, fact where dk = fk "
           f"group by fk, attr {limit or 'order by fk'}")
    dev0, host0 = _match_counts()
    jout, jst, pout, pst, routing, _ = _run_both(paths, sql)
    assert pst == jst == [("fact", "topk" if limit else "select")]
    assert "host" not in routing["routes"]
    assert _match_counts() == (dev0, host0 + 1)
    _assert_same(jout, pout)


@pytest.mark.parametrize("fixture,sql", [("star", Q_TOPK), ("star", Q_FULL),
                                         ("coupled_star", Q_COUPLED)],
                         ids=["topk", "select", "secondary"])
def test_device_match_counts_each_partition_run(request, fixture, sql):
    """Integer keys: every partition run matches again on the device (the
    warm runs too: no match is kept across runs), one count each, and no
    host search; the answers of the runs are equal."""
    stage, tctx = _port_stage(request.getfixturevalue(fixture), sql)
    dev0, host0 = _match_counts()
    outs = [stage.run(0, tctx) for _ in range(3)]
    assert _match_counts() == (dev0 + 3, host0)
    assert outs[0].equals(outs[1]) and outs[0].equals(outs[2])


def test_rank_keys_are_resident_with_the_entry(star):
    """The resident rank keys count in the pinned entry's device bytes (8
    bytes a rank), and an evicted entry gives them back."""
    from ballista_tpu_torch.ops import runtime as rt

    stage, tctx = _port_stage(star, Q_TOPK)
    rt.reset_residency()
    stage.run(0, tctx)
    ent = stage._prepared[0]
    ranks = len(ent["rank_keys"])
    nbytes = rt.entry_device_bytes(ent)
    without = rt.entry_device_bytes({k: v for k, v in ent.items() if k != "rank_keys_dev"})
    assert nbytes - without == 8 * ranks
    assert rt.resident_bytes() == nbytes
    # another stage's pin of the same size under a budget for one evicts it
    other = type("Other", (), {"_device_cache": {}})()
    assert rt.reserve_and_pin(other, 0, {}, other._device_cache, nbytes, nbytes)
    assert stage._prepared == {}
    assert rt.residency_stats()["evictions"] >= 1
    assert rt.resident_bytes() == nbytes
    rt.release_stage_residency(other)
