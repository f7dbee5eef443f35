"""Scan-path confinement for plans arriving over the wire.

An ExecutePartition ticket or a PollWork task carries a serialized physical
plan from an unauthenticated peer; deserialized scan nodes name host file
paths. The reference executes whatever the plan says
(rust/executor/src/flight_service.rs:90-192) — any readable file on the
executor host is fair game. Here the executor's OWN configuration (never
the per-job client settings, which a peer controls) may pin a data-root
allowlist, enforced in two layers:

  1. check_proto_scan_roots runs on the RAW proto before deserialization —
     constructing a ParquetTableSource already reads the file footer, so
     even building the plan from a hostile path would hand the peer an
     existence/readability oracle for arbitrary host files.
  2. check_scan_roots runs on the constructed plan — source file discovery
     resolves directories and symlinks, so the resolved file list is
     re-checked against the roots.
"""

from __future__ import annotations

import os
from typing import Iterator, List

from ballista_tpu_torch.errors import PlanError


def _real_roots(roots: List[str]) -> List[str]:
    return [os.path.realpath(r) for r in roots]


def _contained_real(p: str, r: str) -> bool:
    """The single containment comparison for every trust boundary here —
    both arguments must already be realpath'd; a hardening fix to the rule
    itself lands everywhere at once."""
    return os.path.commonpath([r, p]) == r


def resolve_contained(path: str, root: str):
    """Returns the RESOLVED path when it lies inside root (symlinks
    followed), else None — callers must use the returned string, never
    re-resolve (a second realpath of a swapped symlink could escape the
    check)."""
    p = os.path.realpath(path)
    return p if _contained_real(p, os.path.realpath(root)) else None


def contained(path: str, root: str) -> bool:
    return resolve_contained(path, root) is not None


def _under(path: str, real_roots: List[str]) -> bool:
    p = os.path.realpath(path)
    return any(_contained_real(p, r) for r in real_roots)


def _walk_messages(msg) -> Iterator:
    yield msg
    for fd, val in msg.ListFields():
        if fd.type != fd.TYPE_MESSAGE:
            continue
        for v in (val if fd.is_repeated else [val]):
            yield from _walk_messages(v)


def check_proto_scan_roots(plan_proto, roots: List[str]) -> None:
    """Refuse scan paths outside the allowlist BEFORE the plan (and with it
    any table source that touches disk at construction) is deserialized."""
    if not roots:
        return
    from ballista_tpu_torch.proto import ballista_pb2 as pb

    real = _real_roots(roots)
    for node in _walk_messages(plan_proto):
        if isinstance(node, pb.TableSourceDesc):
            # fail CLOSED: anything that is not the in-memory type is
            # treated as file-backed, so a future disk-backed table type
            # cannot silently bypass the check
            if node.table_type != "memory" and node.path:
                if not _under(node.path, real):
                    raise PlanError(
                        "scan path outside configured data roots refused: "
                        f"{node.path!r}"
                    )


def check_scan_roots_path(path: str, roots: List[str]) -> None:
    """Single-path form, for CREATE EXTERNAL TABLE locations and
    GetFileMetadata requests."""
    if roots and not _under(path, _real_roots(roots)):
        raise PlanError(
            f"scan path outside configured data roots refused: {path!r}"
        )


def check_scan_files(files, roots: List[str]) -> None:
    """Resolved-file-list form: discovery follows symlinks, so the files a
    source actually resolved to are re-checked against the roots."""
    if not roots:
        return
    real = _real_roots(roots)
    for f in files:
        if not _under(f, real):
            raise PlanError(
                f"scan path outside configured data roots refused: {f!r}"
            )


def check_scan_roots(plan, roots: List[str]) -> None:
    """Raise PlanError if a file-backed scan leaf escapes the allowlist.

    roots == [] means unrestricted (the standalone/local default, where the
    client and executor are the same trust domain).
    """
    if not roots:
        return

    def walk(node):
        src = getattr(node, "source", None)
        files = getattr(src, "files", None)
        if files:
            check_scan_files(files, roots)
        for c in node.children():
            walk(c)
        # stage wrappers that deliberately hide their subtree from planner
        # recursion (SpmdAggregateExec) still carry scans
        sub = getattr(node, "subplan", None)
        if sub is not None:
            walk(sub)

    walk(plan)
