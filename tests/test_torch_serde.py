"""The port's wire serde (ballista_tpu_torch/serde, proto) against the JAX
package's, on the TPC-H plans (benchmarks/tpch/datagen, SF 0.002, 2 files
per table, seed 20261017).

- The port's proto registers the same serialized descriptor as the JAX
  package's, so the two share their message classes in one process.
- Every physical plan of the 22 queries, in the shape the scheduler plans
  (Partial / exchange / Final), and every logical plan round-trips through
  the port's serde with its display_indent() unchanged. The one exception
  is the reference's own: a FINAL aggregate is rebuilt on decode over its
  partial state columns, so its line changes once (the JAX package's serde
  does the same); the decoded plan is then a fixed point, bytes and text.
- For the queries with no subquery alias (the port numbers its aliases per
  statement, the JAX package names them after id()), the bytes one package
  encodes decode in the other to the same plan text, both ways: the two
  packages are wire-compatible.
- A mesh stage node (spmd_aggregate / spmd_join) round-trips through the
  port's serde, and the JAX package's bytes for it decode in the port to
  the same plan. (The test keeps the name it had when the port raised
  SerdeError for these nodes.)
"""

import pathlib

import pytest

from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import ExecutionContext as JaxContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import ExecutionContext

ROOT = pathlib.Path(__file__).resolve().parent.parent
QUERIES = [f"q{i}" for i in range(1, 23)]
# the queries whose plans carry no synthetic subquery alias
NO_ALIAS = ["q1", "q3", "q5", "q6", "q7", "q8", "q9", "q10", "q12", "q13", "q14", "q19"]
# the scheduler's planning shape: distributed jobs keep Partial/exchange/Final
SCHEDULER_SHAPE = {"ballista.tpu.coalesce_aggregates": "false",
                   "ballista.tpu.layout_cache_dir": "", "ballista.tpu.cost_model_dir": ""}
# the plan line a decode rebuilds (see the module docstring)
_FINAL = "HashAggregateExec: mode=final,"


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    from benchmarks.tpch.datagen import generate

    d = tmp_path_factory.mktemp("tpch_serde")
    generate(str(d), sf=0.002, parts=2, seed=20261017)
    return str(d)


@pytest.fixture(scope="module")
def contexts(tpch_dir):
    from benchmarks.tpch.datagen import register_all

    port = ExecutionContext(BallistaConfig(SCHEDULER_SHAPE), device="cpu")
    jax = JaxContext(JaxConfig(SCHEDULER_SHAPE))
    register_all(port, tpch_dir)
    register_all(jax, tpch_dir)
    return port, jax


def _sql(name: str) -> str:
    return (ROOT / f"benchmarks/tpch/queries/{name}.sql").read_text()


def _physical(ctx, name):
    return ctx.create_physical_plan(ctx.sql(_sql(name)).logical_plan())


def test_descriptor_is_byte_identical():
    from ballista_tpu.proto import ballista_pb2 as jpb
    from ballista_tpu_torch.proto import ballista_pb2 as tpb

    assert tpb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert tpb.PhysicalPlanNode is jpb.PhysicalPlanNode


@pytest.mark.parametrize("name", QUERIES)
def test_plans_round_trip(contexts, name):
    from ballista_tpu_torch.proto import ballista_pb2 as pb
    from ballista_tpu_torch.serde.logical import plan_from_proto, plan_to_proto
    from ballista_tpu_torch.serde.physical import phys_plan_from_proto, phys_plan_to_proto

    port, _ = contexts
    logical = port.sql(_sql(name)).logical_plan()
    node = pb.LogicalPlanNode()
    node.ParseFromString(plan_to_proto(logical).SerializeToString())
    assert plan_from_proto(node).display_indent() == logical.display_indent()

    physical = _physical(port, name)
    node = pb.PhysicalPlanNode()
    node.ParseFromString(phys_plan_to_proto(physical).SerializeToString())
    decoded = phys_plan_from_proto(node)
    before, after = physical.display_indent(), decoded.display_indent()
    assert [a for a, b in zip(before.splitlines(), after.splitlines())
            if a != b and not a.lstrip().startswith(_FINAL)] == []
    assert len(before.splitlines()) == len(after.splitlines())
    # the decoded plan round-trips unchanged: the same bytes, the same text
    blob = phys_plan_to_proto(decoded).SerializeToString()
    node = pb.PhysicalPlanNode()
    node.ParseFromString(blob)
    again = phys_plan_from_proto(node)
    assert again.display_indent() == after
    assert phys_plan_to_proto(again).SerializeToString() == blob


@pytest.mark.parametrize("name", NO_ALIAS)
def test_wire_compatible_with_reference(contexts, name):
    from ballista_tpu.proto import ballista_pb2 as jpb
    from ballista_tpu.serde import logical as jlog
    from ballista_tpu.serde import physical as jphys
    from ballista_tpu_torch.proto import ballista_pb2 as tpb
    from ballista_tpu_torch.serde import logical as tlog
    from ballista_tpu_torch.serde import physical as tphys

    port, jax = contexts
    jplan, tplan = _physical(jax, name), _physical(port, name)
    assert tplan.display_indent() == jplan.display_indent()
    jbytes = jphys.phys_plan_to_proto(jplan).SerializeToString()
    tbytes = tphys.phys_plan_to_proto(tplan).SerializeToString()
    assert tbytes == jbytes
    # JAX package -> port, and port -> JAX package: each side decodes the
    # other's bytes to the plan its own decode gives
    node = tpb.PhysicalPlanNode()
    node.ParseFromString(jbytes)
    jnode = jpb.PhysicalPlanNode()
    jnode.ParseFromString(tbytes)
    assert (tphys.phys_plan_from_proto(node).display_indent()
            == jphys.phys_plan_from_proto(jnode).display_indent())
    assert (tphys.phys_plan_to_proto(tphys.phys_plan_from_proto(node)).SerializeToString()
            == jphys.phys_plan_to_proto(jphys.phys_plan_from_proto(jnode)).SerializeToString())

    # the client's logical plans travel the same way
    jl, tl = jax.sql(_sql(name)).logical_plan(), port.sql(_sql(name)).logical_plan()
    node = tpb.LogicalPlanNode()
    node.ParseFromString(jlog.plan_to_proto(jl).SerializeToString())
    assert tlog.plan_from_proto(node).display_indent() == jl.display_indent()
    node = jpb.LogicalPlanNode()
    node.ParseFromString(tlog.plan_to_proto(tl).SerializeToString())
    assert jlog.plan_from_proto(node).display_indent() == tl.display_indent()


@pytest.mark.parametrize("which", ["spmd_aggregate", "spmd_join"])
def test_mesh_stage_node_raises(contexts, which):
    """The mesh node wrapping q1's plan round-trips (bytes and text fixed
    points after the first decode), and the JAX package's encoding of the
    same node decodes in the port to the same plan text, both ways."""
    from ballista_tpu.parallel.spmd_join import SpmdJoinExec as JaxJoin
    from ballista_tpu.parallel.spmd_stage import SpmdAggregateExec as JaxAgg
    from ballista_tpu.proto import ballista_pb2 as jpb
    from ballista_tpu.serde import physical as jser
    from ballista_tpu_torch.parallel.spmd_join import SpmdJoinExec
    from ballista_tpu_torch.parallel.spmd_stage import SpmdAggregateExec
    from ballista_tpu_torch.proto import ballista_pb2 as pb
    from ballista_tpu_torch.serde.physical import phys_plan_from_proto, phys_plan_to_proto

    port, jax = contexts
    name = "q1" if which == "spmd_aggregate" else "q3"
    port_cls, jax_cls = ((SpmdAggregateExec, JaxAgg) if which == "spmd_aggregate"
                         else (SpmdJoinExec, JaxJoin))

    def inner(plan, cls):
        """The subtree the mesh node wraps: q1's Final(Repartition(Partial))
        or q3's first partitioned join."""
        from ballista_tpu.physical import aggregate as jagg, join as jjoin
        from ballista_tpu_torch.physical import aggregate as tagg, join as tjoin

        def ok(n):
            if cls in (SpmdAggregateExec, JaxAgg):
                agg = tagg if cls is SpmdAggregateExec else jagg
                return (isinstance(n, agg.HashAggregateExec) and n.mode == agg.AggregateMode.FINAL
                        and isinstance(getattr(n.input, "input", None), agg.HashAggregateExec))
            join = tjoin if cls is SpmdJoinExec else jjoin
            return isinstance(n, join.HashJoinExec)

        stack = [plan]
        while stack:
            n = stack.pop()
            if ok(n):
                return n
            stack.extend(reversed(n.children()))
        raise AssertionError(f"no subtree for {cls.__name__}")

    node = port_cls(inner(_physical(port, name), port_cls))
    wire = phys_plan_to_proto(node)
    assert wire.WhichOneof("plan_type") == which
    back = phys_plan_from_proto(wire)
    assert isinstance(back, port_cls)
    again = phys_plan_from_proto(phys_plan_to_proto(back))
    assert phys_plan_to_proto(again).SerializeToString() == phys_plan_to_proto(back).SerializeToString()
    assert again.subplan.display_indent() == back.subplan.display_indent()

    jnode = jax_cls(inner(_physical(jax, name), jax_cls))
    got = pb.PhysicalPlanNode()
    got.ParseFromString(jser.phys_plan_to_proto(jnode).SerializeToString())
    decoded = phys_plan_from_proto(got)
    assert isinstance(decoded, port_cls)
    assert decoded.subplan.display_indent() == back.subplan.display_indent()
    jgot = jpb.PhysicalPlanNode()
    jgot.ParseFromString(wire.SerializeToString())
    jdecoded = jser.phys_plan_from_proto(jgot)
    assert isinstance(jdecoded, jax_cls)
    assert jdecoded.subplan.display_indent() == back.subplan.display_indent()
