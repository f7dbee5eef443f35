"""Multi-process mesh utilities: the process-boundary decomposition of a
mesh stage, on torch.distributed.

Contract (the one parallel/spmd_stage.py's per-shard decomposition is
written against):

  - input partition p belongs to mesh shard ``p % n_shards``; a process
    reads only partitions whose shard it owns (batches may balance freely
    among a process's own shards);
  - processes exchange only their distinct group keys; every process ranks
    the gathered union identically (same input, same deterministic sort),
    so global group ids agree with no central coordinator;
  - any decline (unsupported shape, overflow risk) is collective: processes
    agree with an all-gather before leaving the mesh path, or one process
    would enter the collectives alone and hang the others.

The process group is the caller's: initialize torch.distributed from the
environment (address, world size, rank), as jax.distributed.initialize is
called in the JAX package. Without an initialized group every function
returns its local value. The backend is gloo for CPU tensors and NCCL for
CUDA tensors: the exchange buffers live on the CPU under gloo and on the
current CUDA device under NCCL.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_count() -> int:
    """World size of the initialized process group (1 without one)."""
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def comm_device():
    """Where collective buffers live: the current CUDA device under NCCL,
    the CPU otherwise."""
    import torch

    dist = _dist()
    if dist is not None and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def local_shard_ids(mesh) -> List[int]:
    """Flat mesh-shard indices owned by this process."""
    pid = process_index()
    return [i for i, r in enumerate(mesh.ranks) if r == pid]


def partition_shard(p: int, n_shards: int) -> int:
    """The process-boundary read-ownership rule: partition -> shard."""
    return p % n_shards


def owned_partitions(n_parts: int, mesh) -> List[int]:
    """Partitions this process must read (its shards' partitions)."""
    n_shards = int(np.prod(list(mesh.shape.values())))
    mine = set(local_shard_ids(mesh))
    return [p for p in range(n_parts) if partition_shard(p, n_shards) in mine]


def _allgather_equal(arr: np.ndarray) -> np.ndarray:
    """All-gather one same-shaped array per process -> [world, *shape]."""
    import torch

    dist = _dist()
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(comm_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    # ballista-lint: disable=readback-discipline -- the collective's own hand-off of host planning scalars (row counts, distinct keys, decline flags), not a result; the JAX package's process_allgather counts none either
    return np.stack([o.cpu().numpy() for o in out])


def allgather_rows(x: np.ndarray) -> np.ndarray:
    """Gather variable-length per-process 1-D arrays; returns the
    concatenation in rank order (identical on every process). Lengths are
    exchanged first, then data padded to the longest."""
    # bool -> int64 up front: every return path must agree on dtype
    x = np.asarray(x)
    if x.dtype == np.bool_:
        x = x.astype(np.int64)
    if process_count() == 1:
        return x
    lens = _allgather_equal(np.array([len(x)], dtype=np.int64)).reshape(-1)
    pad = int(lens.max()) if len(lens) else 0
    if not pad:
        return np.zeros(0, dtype=x.dtype)
    padded = np.zeros(pad, dtype=x.dtype)
    padded[: len(x)] = x
    gathered = _allgather_equal(padded)
    return np.concatenate([gathered[i, : int(lens[i])] for i in range(len(lens))])


def agree(ok: bool) -> bool:
    """Collective AND across processes: declines must be unanimous."""
    if process_count() == 1:
        return ok
    flags = _allgather_equal(np.array([1 if ok else 0], dtype=np.int64))
    return bool(flags.min() == 1)


def global_max(v: int) -> int:
    if process_count() == 1:
        return int(v)
    return int(_allgather_equal(np.array([int(v)], dtype=np.int64)).max())


def make_sharded(mesh, blocks: Dict[int, np.ndarray], total_len: int,
                 dtype) -> Dict[int, object]:
    """This process's part of a global array sharded on axis 0: blocks maps
    each local flat shard id to an np.ndarray of total_len // n leading
    rows (trailing dims equal on every block); returns shard id -> tensor
    on that shard's device. Every shard id this process owns must be
    present."""
    import torch

    from ballista_tpu_torch.ops.runtime import upload

    n = int(np.prod(list(mesh.shape.values())))
    block = total_len // n
    mine = local_shard_ids(mesh)
    trailing = blocks[mine[0]].shape[1:] if mine else ()
    devs = mesh.flat_devices()
    out = {}
    for i in mine:
        b = blocks[i]
        if b.shape != (block,) + trailing:
            raise ValueError(f"shard {i} block {b.shape}, expected {(block,) + trailing}")
        out[i] = upload(b.astype(dtype, copy=False), torch.device(devs[i]))
    return out
