"""Normalized logical-plan fingerprints for the result / plan caches.

The persisted layout cache (ops/kernels.py stage keys -> ops/layout_cache.py)
established the "fully file-backed identity" rule: an artifact may only be
reused across processes when its key covers EVERY input's identity — file
paths + mtimes for file-backed scans, embedded content for memory tables —
so a rewritten input misses cleanly instead of silently serving stale data.
This module applies the same rule one level up, to whole queries:

- ``content_key``  hashes the serialized logical plan proto (memory-table
  data rides inside it as Arrow IPC bytes, so it is content-addressed by
  construction) plus every result-affecting setting. This is the CROSS-JOB
  identity of "the same query over the same sources": the scheduler's
  physical-plan cache keys on it, so N tenants submitting the same
  dashboard query pay optimize+planning once.
- ``result_key``   extends the content key with each scan file's (path,
  mtime, size) triple. This keys the RESULT cache: touching an input
  file's mtime changes the key, so the stale entry is simply never found
  again (invalidation by construction, exactly like the layout cache).

Tenancy settings (``ballista.tenant.*``) are EXCLUDED from both keys: the
whole point of the artifact economy is that tenants share; admission
control isolates their execution, not their cache lines. A plan with any
non-file, non-memory source (or a missing file), or containing a VOLATILE
scalar function (now() — its value depends on when the query runs, not on
its inputs), is not fingerprintable and returns None — an un-keyable
query must never produce a cache entry.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional, Tuple

from ballista_tpu_torch.logical import plan as lp


def _walk_sources(plan: lp.LogicalPlan):
    if isinstance(plan, lp.TableScan):
        yield plan.source
    for c in plan.children():
        yield from _walk_sources(c)


# scalar functions whose value depends on WHEN the query runs, not on its
# inputs (physical/expr.py evaluates now() at execution time): a plan
# containing one has no stable result identity and must never be cached
_VOLATILE_FNS = frozenset({"now"})


def _has_volatile_fn(msg) -> bool:
    """Recursively scan a plan proto for ScalarFunctionNode.fn in the
    volatile set — proto-level, so every expression position (filters,
    projections, join filters, subquery rewrites) is covered without
    tracking the logical expr shapes."""
    from google.protobuf.message import Message

    if type(msg).__name__ == "ScalarFunctionNode" and msg.fn in _VOLATILE_FNS:
        return True
    for fd, value in msg.ListFields():
        if fd.type != fd.TYPE_MESSAGE:
            continue
        # a repeated message field lists as a container, a singular one as
        # the Message itself (ducks around the deprecated fd.label API)
        children = (value,) if isinstance(value, Message) else value
        if any(_has_volatile_fn(v) for v in children):
            return True
    return False


def _settings_component(settings: Dict[str, str]) -> str:
    """Result-affecting settings, canonically ordered. Tenancy keys are
    excluded (tenants share cache lines); so is ballista.cache.advance —
    advancement is bit-identical to a cold run by contract (ISSUE 19), so
    advance-on and advance-off clients must share content keys. Everything
    else a client set participates — backend choice, batch size, chaos
    arming etc. can all change result bytes or execution shape, and a
    false cache hit across them would be silent corruption."""
    items = sorted(
        (k, v) for k, v in settings.items()
        if not k.startswith("ballista.tenant.")
        and k != "ballista.cache.advance"
    )
    return ";".join(f"{k}={v}" for k, v in items)


def plan_file_facts(plan: lp.LogicalPlan) -> Optional[list]:
    """Every scan file's ``path|mtime|size`` fact, or None when any source
    is neither file-backed nor content-embedded (or a file is unstattable).
    The facts are the per-file half of ``result_key`` — and the unit of the
    advancement probe (ISSUE 19): a cached entry whose fact set is a strict
    subset of a new submission's facts covers a prefix of its inputs."""
    file_facts = []
    for src in _walk_sources(plan):
        files = getattr(src, "files", None)
        if files:
            for f in files:
                try:
                    st = os.stat(f)
                except OSError:
                    return None  # identity does not cover this leaf
                file_facts.append(f"{f}|{st.st_mtime}|{st.st_size}")
        elif getattr(src, "partitions", None) is not None:
            # memory table: its data serializes INTO the plan proto as
            # Arrow IPC partitions, so the content hash already covers it
            continue
        else:
            return None  # neither file-backed nor content-embedded
    return file_facts


def plan_fingerprint(
    plan: lp.LogicalPlan, settings: Dict[str, str], file_facts=None
) -> Optional[Tuple[str, str]]:
    """(content_key, result_key) for a fully identifiable plan, else None.

    content_key: sha256 over (plan proto bytes, result-affecting settings).
    result_key:  sha256 over (content_key, sorted (path, mtime, size) of
    every scan file) — the result-cache identity with mtime invalidation
    built into the key.

    Pass `file_facts` (from plan_file_facts) when the caller already holds
    them, so the key and the caller's fact set are built from ONE stat per
    file — a file rewritten between two stats must not leave a cache entry
    whose scan_fact disagrees with the result_key it sits under.
    """
    from ballista_tpu_torch.proto import ballista_pb2 as pb  # noqa: F401
    from ballista_tpu_torch.serde.logical import plan_to_proto

    if file_facts is None:
        file_facts = plan_file_facts(plan)
    if file_facts is None:
        return None
    try:
        proto = plan_to_proto(plan)
    except Exception:
        return None  # unserializable plans carry no stable identity
    if _has_volatile_fn(proto):
        return None  # now() etc.: results depend on execution time
    proto_bytes = proto.SerializeToString()
    h = hashlib.sha256()
    h.update(proto_bytes)
    h.update(b"\x00")
    h.update(_settings_component(settings).encode())
    content_key = h.hexdigest()
    h2 = hashlib.sha256()
    h2.update(content_key.encode())
    for fact in sorted(file_facts):
        h2.update(b"\x00")
        h2.update(fact.encode())
    return content_key, h2.hexdigest()
