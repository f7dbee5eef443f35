"""Stable subquery aliases in the port's SQL planner
(ballista_tpu_torch/sql/planner.py): the synthetic names of EXISTS, IN, the
IN value, the NOT IN null count and scalar subqueries are ordinals in
planning order within one statement, not id() of an AST node. Two plannings
of the same SQL therefore give the same plan text and the same device stage
keys, which is what lets a stage (and a persisted layout) be found again.

TPC-H at SF 0.002 (benchmarks/tpch/datagen, 2 files per table, seed
20261016). Answers are held against the JAX package's: non-float columns
equal, floats within rtol 1e-3 (tests/test_torch_tpch_all.py).
"""

import pathlib
import re

import numpy as np
import pyarrow as pa
import pytest

import ballista_tpu_torch.config as _port_config
from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import ExecutionContext
from ballista_tpu_torch.ops import kernels, runtime

from test_torch_layout_cache import reset_jax, reset_port

_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_LAYOUT_CACHE_DIR] = ""
_port_config.DEFAULT_SETTINGS[_port_config.BALLISTA_TPU_COST_MODEL_DIR] = ""

ROOT = pathlib.Path(__file__).resolve().parent.parent
SETTINGS = {"ballista.tpu.layout_cache_dir": "", "ballista.tpu.cost_model_dir": ""}
QUERIES = ["q2", "q4", "q17", "q18", "q20", "q22"]
ALL_QUERIES = [f"q{i}" for i in range(1, 23)]


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    from benchmarks.tpch.datagen import generate

    d = tmp_path_factory.mktemp("tpch_alias")
    generate(str(d), sf=0.002, parts=2, seed=20261016)
    return str(d)


@pytest.fixture(autouse=True)
def _fresh():
    from ballista_tpu.ops import costmodel as jcm
    from ballista_tpu_torch.ops import costmodel as tcm

    tcm.reset(clear_dir=True)
    jcm.reset(clear_dir=True)
    reset_port()
    reset_jax()
    yield
    reset_port()
    reset_jax()


def _sql(name):
    return (ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text()


def _port_ctx(tpch_dir):
    from benchmarks.tpch.datagen import register_all

    ctx = ExecutionContext(BallistaConfig(SETTINGS), device="cpu")
    register_all(ctx, tpch_dir)
    return ctx


def _stage_keys(ctx, sql):
    """(physical plan text, stage key of every aggregate node) of one
    planning of `sql`."""
    from ballista_tpu_torch.physical.plan import TaskContext

    plan = ctx.create_physical_plan(ctx.sql(sql).logical_plan())
    task = TaskContext(config=ctx.config, device=ctx.device)
    keys, stack = [], [plan]
    while stack:
        node = stack.pop()
        if type(node).__name__ == "HashAggregateExec":
            keys.append(kernels.stage_identity(node, task)["key"])
        stack.extend(node.children())
    return plan.display_indent(), sorted(keys)


@pytest.mark.parametrize("name", ALL_QUERIES)
def test_two_plannings_give_the_same_stage_keys(tpch_dir, name):
    ctx = _port_ctx(tpch_dir)
    text1, keys1 = _stage_keys(ctx, _sql(name))
    text2, keys2 = _stage_keys(_port_ctx(tpch_dir), _sql(name))
    assert keys1 and keys1 == keys2
    assert text1 == text2
    # the synthetic aliases are small ordinals, never an object address
    for alias in re.findall(r"__(?:exists|in|in_val|in_nullcnt|sq|sqk)_(\d+)", text1):
        assert int(alias) < 100, alias


def test_nested_in_subqueries_get_distinct_aliases(tpch_dir):
    """q20 nests IN inside IN: one counter per statement keeps every alias
    unique, and a new statement starts again from 0."""
    ctx = _port_ctx(tpch_dir)
    text = ctx.sql(_sql("q20")).logical_plan().display_indent()
    aliases = re.findall(r"__in_(\d+)", text)
    assert len(set(aliases)) >= 2
    assert "0" in aliases


@pytest.mark.parametrize("name", QUERIES)
def test_answers_match_reference(tpch_dir, name):
    from benchmarks.tpch.datagen import register_all

    got = _port_ctx(tpch_dir).sql(_sql(name)).collect()
    # the reference run needs no AOT disk tier: exporting each traced
    # program to .ballista_cache/aot was a large share of its time
    jctx = JaxContext(JaxConfig({**SETTINGS, "ballista.executor.backend": "tpu",
                                 "ballista.tpu.aot_cache": ""}))
    register_all(jctx, tpch_dir)
    want = jctx.sql(_sql(name)).collect()
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows
    for c, f in zip(want.column_names, want.schema):
        a = got.column(c).to_numpy(zero_copy_only=False)
        b = want.column(c).to_numpy(zero_copy_only=False)
        if pa.types.is_floating(f.type):
            np.testing.assert_allclose(a, b, rtol=1e-3)
        else:
            assert list(a) == list(b), c


def test_second_q18_run_hits_the_stage_cache(tpch_dir):
    """With stable aliases a second q18 finds its fact stage again: no new
    stage and no prepare (ingest_stats()["prepares"] 0), the same answer."""
    from ballista_tpu_torch.ops.factagg import FactAggregateStage

    ctx = _port_ctx(tpch_dir)
    first = ctx.sql(_sql("q18")).collect()
    stages = dict(kernels._stage_cache)
    assert any(isinstance(s, FactAggregateStage) for s in stages.values())
    runtime.ingest_stats(reset=True)
    runtime.routing_stats(reset=True)
    second = _port_ctx(tpch_dir).sql(_sql("q18")).collect()
    assert runtime.ingest_stats(reset=True)["prepares"] == 0
    assert runtime.routing_stats(reset=True)["routes"].get("fact_select", 0) >= 1
    assert set(kernels._stage_cache) == set(stages)
    assert second.equals(first)
