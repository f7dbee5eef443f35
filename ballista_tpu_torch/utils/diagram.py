"""GraphViz emitter for query-stage DAGs (ref rust/core/src/utils.rs:190-290
produce_diagram). Render with `dot -Tpng out.dot`."""

from __future__ import annotations

from typing import List

from ballista_tpu_torch.distributed.planner import find_unresolved_shuffles
from ballista_tpu_torch.distributed.stages import ShuffleWriterExec
from ballista_tpu_torch.physical.plan import ExecutionPlan


def _label(node: ExecutionPlan) -> str:
    return node.fmt().replace('"', "'")


def produce_diagram(stages: List[ShuffleWriterExec]) -> str:
    lines = ["digraph G {", "  rankdir=BT;", "  node [shape=box, fontname=monospace];"]
    counter = [0]

    def emit(node: ExecutionPlan, cluster: int) -> str:
        nid = f"s{cluster}_n{counter[0]}"
        counter[0] += 1
        lines.append(f'    {nid} [label="{_label(node)}"];')
        for c in node.children():
            cid = emit(c, cluster)
            lines.append(f"    {cid} -> {nid};")
        return nid

    roots = {}
    for stage in stages:
        lines.append(f"  subgraph cluster_{stage.stage_id} {{")
        lines.append(f'    label="Stage {stage.stage_id}";')
        roots[stage.stage_id] = emit(stage, stage.stage_id)
        lines.append("  }")

    # cross-stage edges: UnresolvedShuffle -> producing stage root
    for stage in stages:
        for u in find_unresolved_shuffles(stage):
            if u.stage_id in roots:
                lines.append(
                    f'  {roots[u.stage_id]} -> {roots[stage.stage_id]} '
                    f'[style=dashed, label="shuffle"];'
                )
    lines.append("}")
    return "\n".join(lines)


def plan_diagram(plan: ExecutionPlan) -> str:
    """Single-plan dot graph (no stages)."""
    lines = ["digraph G {", "  rankdir=BT;", "  node [shape=box, fontname=monospace];"]
    counter = [0]

    def emit(node: ExecutionPlan) -> str:
        nid = f"n{counter[0]}"
        counter[0] += 1
        lines.append(f'  {nid} [label="{_label(node)}"];')
        for c in node.children():
            cid = emit(c)
            lines.append(f"  {cid} -> {nid};")
        return nid

    emit(plan)
    lines.append("}")
    return "\n".join(lines)
