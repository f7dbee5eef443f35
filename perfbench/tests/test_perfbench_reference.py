"""Each NumPy reference against the port's "cpu" backend (Arrow host
kernels) on the same Parquet files at SF 0.01: on TPC-H's validation
parameters and on seeded draws. A test of the reference, not the
reference: its answers never come from the port."""

import os

import numpy as np
import pytest

from perfbench import catalog
from perfbench.compare import compare
from perfbench.reference.tables import Tables
from perfbench.tpch.schema import TPCH_TABLES

TEMPLATES = ["q1", "q3", "q5", "q6", "q10", "q12"]


@pytest.fixture(scope="module")
def host_ctx(tiny_db):
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import ExecutionContext

    ctx = ExecutionContext(BallistaConfig({"ballista.executor.backend": "cpu",
                                           "ballista.tpu.layout_cache_dir": "",
                                           "ballista.tpu.cost_model_dir": ""}), device="cpu")
    for t in TPCH_TABLES:
        ctx.register_parquet(t, os.path.join(tiny_db, t))
    return ctx


def _params(name):
    t = catalog.Template(name)
    space = t.params.space()
    rng = np.random.default_rng(7)
    return [t.params.VALIDATION] + [space[i] for i in rng.choice(len(space), 3, replace=False)]


@pytest.mark.parametrize("name", TEMPLATES)
def test_reference_agrees_with_the_host_backend(name, tiny_db, host_ctx):
    t = catalog.Template(name)
    tables = Tables(tiny_db)
    for p in _params(name):
        got = host_ctx.sql(t.query(p).sql).collect()
        assert got.num_rows > 0, p
        bad, gap, why = compare(got, t.reference.answer(tables, p), t.reference, 1e-12)
        assert bad == 0, (p, why)
        assert gap <= 1e-12, p


@pytest.mark.parametrize("name", ["q1", "q3"])
def test_rows_out_of_the_whole_order_by_are_a_mismatch(name, tiny_db):
    """Rows right one by one, but two of them equal in the first ORDER BY
    key and out of order in the second: q1's two rows of one l_returnflag,
    or two q3 rows of one revenue in descending o_orderdate."""
    from perfbench.control import to_table

    t = catalog.Template(name)
    want = dict(t.reference.answer(Tables(tiny_db), t.params.VALIDATION))
    first, second = (c for c, _ in t.reference.ORDER)
    if name == "q3":
        # rows 0 and 1 given one revenue: the earlier o_orderdate goes first
        want["revenue"] = np.array(want["revenue"], copy=True)
        want["revenue"][1] = want["revenue"][0]
        assert want["o_orderdate"][0] != want["o_orderdate"][1]
        if want["o_orderdate"][0] > want["o_orderdate"][1]:
            want = {c: [v[1], v[0], *v[2:]] if isinstance(v, list) else v[[1, 0, *range(2, len(v))]]
                    for c, v in want.items()}
    right = to_table(want, t.reference.LIMIT)
    assert compare(right, want, t.reference, 1e-12)[0] == 0
    keys = right.column(first).to_pylist()
    i = next(i for i in range(len(keys) - 1) if keys[i] == keys[i + 1])
    assert right.column(second)[i] != right.column(second)[i + 1]
    swapped = right.take([*range(i), i + 1, i, *range(i + 2, right.num_rows)])
    bad, _, why = compare(swapped, want, t.reference, 1e-12)
    assert bad == 1 and "not ordered" in why, why
