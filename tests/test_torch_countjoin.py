"""COUNT over a LEFT join (q13) and SEMI / ANTI membership (q22) as device
membership counting: the port (ballista_tpu_torch/ops/countjoin.py and the
HashJoinExec hook, "cuda" backend on CPU tensors) against the JAX package
("tpu" backend, CPU JAX) and the port's "cpu" backend, on tables made with
numpy from a seed. Counts are exact integers, so answers must be equal;
the join paths must be equal too. Both cost stores are in memory and
emptied before each test.
"""

import numpy as np
import pyarrow as pa
import pytest

import ballista_tpu_torch.config as _port_config
from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import ExecutionContext

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""

Q13_SHAPE = (
    "select c_grp, cnt, count(*) as dist from ("
    "  select c_id, c_grp, count(o_id) as cnt from cust "
    "  left outer join orders on c_id = o_cust group by c_id, c_grp"
    ") sub group by c_grp, cnt order by c_grp, cnt"
)
ANTI = (
    "select c_grp, count(*) as n from cust where not exists ("
    "  select * from orders where o_cust = c_id"
    ") group by c_grp order by c_grp"
)
SEMI = (
    "select c_grp, count(*) as n from cust where exists ("
    "  select * from orders where o_cust = c_id"
    ") group by c_grp order by c_grp"
)


@pytest.fixture(autouse=True)
def _fresh():
    from ballista_tpu.ops import costmodel as jcm
    from ballista_tpu.ops import runtime as jr
    from ballista_tpu_torch.ops import costmodel as tcm
    from ballista_tpu_torch.ops import runtime as tr

    tcm.reset(clear_dir=True)
    jcm.reset(clear_dir=True)
    jr.join_path_stats(reset=True)
    tr.join_path_stats(reset=True)
    yield


def _tables(with_nulls=False):
    rng = np.random.default_rng(23)
    n_c, n_o = 200, 1500
    cust = pa.table({
        "c_id": pa.array(np.arange(n_c), type=pa.int64()),
        "c_grp": pa.array(rng.integers(0, 9, n_c), type=pa.int64()),
    })
    oid = rng.integers(0, 5000, n_o)
    okey = rng.integers(0, int(n_c * 1.3), n_o)  # some point past customers
    orders = {"o_id": pa.array(oid, type=pa.int64()),
              "o_cust": pa.array(okey, type=pa.int64())}
    if with_nulls:
        # nulls in the COUNTED column (COUNT skips them) and in the join
        # key (never matches)
        null_at = rng.random(n_o) < 0.15
        orders["o_id"] = pa.array([None if m else int(v) for v, m in zip(oid, null_at)],
                                  type=pa.int64())
        key_null = rng.random(n_o) < 0.1
        orders["o_cust"] = pa.array([None if m else int(v) for v, m in zip(okey, key_null)],
                                    type=pa.int64())
    return {"cust": cust, "orders": pa.table(orders)}


def _run(tables, sql, settings=None):
    """{backend: (rows, join paths, count_join counter delta)} for the JAX
    "tpu" backend, the port's "cuda" backend and its "cpu" backend."""
    from ballista_tpu.ops import runtime as jr
    from ballista_tpu.utils import tracing as jt
    from ballista_tpu_torch.ops import runtime as tr
    from ballista_tpu_torch.utils import tracing as tt

    settings = settings or {}
    out = {}
    for name, ctx, rt, tracing in (
        ("jax", JaxContext(JaxConfig({**settings, "ballista.executor.backend": "tpu"})), jr, jt),
        ("port", ExecutionContext(BallistaConfig(settings), device="cpu"), tr, tt),
        ("host", ExecutionContext(BallistaConfig({"ballista.executor.backend": "cpu"}),
                                  device="cpu"), tr, tt),
    ):
        for t_name, t in tables.items():
            ctx.register_record_batches(t_name, t, n_partitions=1)
        before = tracing.counters().get("device.count_join", 0)
        rt.join_path_stats(reset=True)
        rows = ctx.sql(sql).collect().to_pylist()
        out[name] = (rows, rt.join_path_stats(reset=True),
                     tracing.counters().get("device.count_join", 0) - before)
    return out


@pytest.mark.parametrize("with_nulls", [False, True])
def test_count_over_left_join(with_nulls):
    """q13's shape: COUNT(right column) grouped by left keys over a LEFT
    join runs as membership counting, NULL counted values and NULL join
    keys included."""
    out = _run(_tables(with_nulls), Q13_SHAPE)
    assert out["port"][0] == out["jax"][0] == out["host"][0]
    assert out["port"][1] == out["jax"][1]
    # one counts pass: over all orders, or over those whose o_id is valid
    assert out["port"][1]["paths"] == {"device": 1}
    assert out["port"][2] == out["jax"][2] == 1
    assert out["host"][2] == 0


def test_count_over_left_join_off_without_device_join():
    out = _run(_tables(), Q13_SHAPE, {"ballista.tpu.device_join": "false"})
    assert out["port"][0] == out["jax"][0] == out["host"][0]
    assert out["port"][2] == out["jax"][2] == 0
    assert out["port"][1] == out["jax"][1] == {"paths": {}, "reasons": {}}


@pytest.mark.parametrize("sql", [ANTI, SEMI], ids=["anti", "semi"])
def test_membership_join(sql):
    """q22's NOT EXISTS (and EXISTS): rows kept off the counts plane,
    equal to the host's anti_right / semi_right selections."""
    out = _run(_tables(), sql)
    assert out["port"][0] == out["jax"][0] == out["host"][0]
    assert out["port"][1] == out["jax"][1]
    assert out["port"][1]["paths"] == {"device": 1}


def test_prescreen_admits_only_counts_of_right_columns():
    """The prescreen admits COUNT of a right-side column grouped by left
    columns and nothing else, in both packages."""
    from ballista_tpu.ops import countjoin as jc
    from ballista_tpu_torch.ops import countjoin as tc

    tables = _tables()
    shapes = {
        "select c_id, count(o_id) as n from cust left join orders on c_id = o_cust "
        "group by c_id": True,
        "select c_id, sum(o_id) as n from cust left join orders on c_id = o_cust "
        "group by c_id": False,
        "select o_id, count(o_id) as n from cust left join orders on c_id = o_cust "
        "group by o_id": False,
        "select c_id, count(o_id) as n from cust join orders on c_id = o_cust "
        "group by c_id": False,
    }
    for sql, admitted in shapes.items():
        got = []
        for ctx, mod in ((JaxContext(JaxConfig({"ballista.executor.backend": "tpu"})), jc),
                         (ExecutionContext(BallistaConfig({}), device="cpu"), tc)):
            for t_name, t in tables.items():
                ctx.register_record_batches(t_name, t, n_partitions=1)
            plan = ctx.create_physical_plan(ctx.sql(sql).logical_plan())
            aggs, stack = [], [plan]
            while stack:
                node = stack.pop()
                if type(node).__name__ == "HashAggregateExec":
                    aggs.append(node)
                stack.extend(node.children())
            got.append(any(mod._match_shape(a) is not None for a in aggs))
        assert got == [admitted, admitted], sql
