"""Mesh stage programs: distributed aggregation and shuffle over a Mesh.

The reference's two distributed primitives map to collectives between mesh
shards:

- partial/final aggregation (HashAggregateExec split plus shuffle): per-shard
  masked segment-sum partials merged by psum, with no materialize-then-fetch;
- repartition exchange (ShuffleWriter -> Flight fetch -> ShuffleReader):
  rows bucketed by key ownership and exchanged with all_to_all, then
  aggregated locally on the owning shard.

This module also holds the collectives themselves. Within one process a
collective is an explicit reduction or exchange over the shards' tensors in
shard order: psum is a sum, pmin / pmax fold floats through their
order-preserving int32 keys (ops/floatbits.py), and all_to_all (tiled,
split and concat on axis 0) is slicing and concatenation in the JAX order.
Across processes the folded value then goes through torch.distributed's
all_reduce (gloo for CPU tensors, NCCL for CUDA tensors).

A global array "sharded on axis 0" is passed whole: shard_blocks cuts it
into one equal block per shard, on that shard's device. Programs are plain
PyTorch on explicit devices; nothing is compiled.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np


def shard_blocks(x, mesh) -> list:
    """Global array (numpy or tensor) -> one equal block per flat shard
    along axis 0, each on its shard's device."""
    import torch

    n = mesh.size
    if x.shape[0] % n:
        raise ValueError(f"axis 0 of {tuple(x.shape)} does not split into {n} shards")
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    b = x.shape[0] // n
    return [x[i * b:(i + 1) * b].to(d) for i, d in enumerate(mesh.flat_devices())]


def _fold_pair(a, b, fold: str):
    import torch

    if fold == "sum":
        return a + b
    return torch.minimum(a, b) if fold == "min" else torch.maximum(a, b)


def collective(parts: Sequence, fold: str):
    """psum / pmin / pmax over per-shard tensors of one shape: folded in
    shard order onto the first shard's device, then all-reduced across
    processes when a process group is up. Returns the replicated value."""
    import torch

    from ballista_tpu_torch.ops import floatbits
    from ballista_tpu_torch.parallel import multihost

    keyed = fold != "sum" and parts[0].is_floating_point()
    out = None
    for p in parts:
        p = p.to(parts[0].device)
        if keyed:
            p = floatbits.torch_f32_to_i32(p.to(torch.float32))
        out = p if out is None else _fold_pair(out, p, fold)
    if multihost.process_count() > 1:
        import torch.distributed as dist

        op = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
              "max": dist.ReduceOp.MAX}[fold]
        buf = out.to(multihost.comm_device()).contiguous()
        dist.all_reduce(buf, op=op)
        out = buf.to(parts[0].device)
    return floatbits.torch_i32_to_f32(out) if keyed else out


def psum(parts):
    return collective(parts, "sum")


def pmin(parts):
    return collective(parts, "min")


def pmax(parts):
    return collective(parts, "max")


def all_to_all(blocks: Sequence, devices: Sequence) -> list:
    """Tiled all_to_all on axis 0 within one process: shard i's block
    splits into len(blocks) equal chunks, chunk j goes to shard j, and
    shard j concatenates what it receives in source-shard order."""
    import torch

    n = len(blocks)
    c = blocks[0].shape[0] // n
    return [
        torch.cat([blocks[i][j * c:(j + 1) * c].to(devices[j]) for i in range(n)])
        for j in range(n)
    ]


def _segment_sum(v, segments, num_segments: int):
    import torch

    out = torch.zeros(num_segments, dtype=v.dtype, device=v.device)
    return out.index_add_(0, segments.long(), v)


def build_psum_aggregate(mesh, num_groups: int,
                         mask_fn: Callable, value_fns: Sequence[Callable]):
    """Aggregation with a replicated output: each shard computes masked
    per-group partial sums from its rows; psum merges them over the mesh.

    The returned fn takes the codes array (group id per row) and the
    per-column arrays, all sharded on axis 0, and returns
    [1 + n_values, num_groups]: row 0 counts, then one row per value
    expression, on the first shard's device."""
    import torch

    def per_shard(codes, *cols):
        mask = mask_fn(*cols)
        maskf = mask.to(torch.float32)
        safe = torch.where(mask, codes, num_groups)  # dump slot
        outs = [_segment_sum(maskf, safe, num_groups + 1)]
        for vf in value_fns:
            v = vf(*cols).to(torch.float32)
            outs.append(_segment_sum(v * maskf, safe, num_groups + 1))
        return torch.stack(outs)[:, :num_groups]  # drop the dump slot

    def fn(codes, *cols):
        shards = [shard_blocks(a, mesh) for a in (codes,) + cols]
        return psum([per_shard(*blocks) for blocks in zip(*shards)])

    return fn


def build_all_to_all_exchange_aggregate(mesh, axis: str = "data"):
    """Shuffle-by-key aggregation: each shard buckets its rows by owning
    shard (key % n_dev), exchanges buckets with all_to_all, and the owner
    aggregates its received rows with a local segment sum.

    Returns fn(keys, values, groups_per_shard), keys and values sharded on
    axis 0 -> owned sums [n_dev * groups_per_shard]: shard i's slice holds
    the sums of keys with key % n_dev == i and key // n_dev <
    groups_per_shard."""
    import torch

    n_dev = mesh.shape[axis]
    devices = mesh.flat_devices()

    def bucket(keys, values):
        s = keys.shape[0]
        tgt = torch.remainder(keys, n_dev).to(torch.int64)
        order = torch.sort(tgt, stable=True).indices
        keys_s, vals_s, tgt_s = keys[order], values[order], tgt[order]
        onehot = torch.nn.functional.one_hot(tgt_s, n_dev).to(torch.int32)
        pos = (torch.cumsum(onehot, dim=0) - onehot).gather(1, tgt_s[:, None])[:, 0]
        # fixed-capacity buckets (worst case: all rows to one target)
        bk = torch.full((n_dev, s), -1, dtype=keys.dtype, device=keys.device)
        bv = torch.zeros((n_dev, s), dtype=values.dtype, device=values.device)
        bk[tgt_s, pos.long()] = keys_s
        bv[tgt_s, pos.long()] = vals_s
        return bk, bv

    def owner_sums(rk, rv, groups_per_shard: int):
        rk, rv = rk.reshape(-1), rv.reshape(-1)
        valid = rk >= 0
        local_group = torch.where(valid, torch.div(rk, n_dev, rounding_mode="floor"),
                                  groups_per_shard)
        sums = _segment_sum(torch.where(valid, rv, torch.zeros_like(rv)),
                            local_group, groups_per_shard + 1)
        return sums[:groups_per_shard]

    def fn(keys, values, groups_per_shard: int):
        buckets = [bucket(k, v) for k, v in zip(shard_blocks(keys, mesh),
                                                 shard_blocks(values, mesh))]
        rk = all_to_all([b[0] for b in buckets], devices)
        rv = all_to_all([b[1] for b in buckets], devices)
        outs = [owner_sums(k, v, groups_per_shard) for k, v in zip(rk, rv)]
        return torch.cat([o.to(devices[0]) for o in outs])

    return fn


def build_q1_style_step(mesh, num_groups: int, cutoff_days: int):
    """TPC-H q1's pipeline as one mesh program: filter mask, four derived
    measures, masked per-group partials, psum. Column layout: (codes, qty,
    price, disc, tax, shipdate)."""

    def mask_fn(qty, price, disc, tax, ship):
        return ship <= cutoff_days

    value_fns: List[Callable] = [
        lambda qty, price, disc, tax, ship: qty,
        lambda qty, price, disc, tax, ship: price,
        lambda qty, price, disc, tax, ship: price * (1.0 - disc),
        lambda qty, price, disc, tax, ship: price * (1.0 - disc) * (1.0 + tax),
        lambda qty, price, disc, tax, ship: disc,
    ]
    return build_psum_aggregate(mesh, num_groups, mask_fn, value_fns)
