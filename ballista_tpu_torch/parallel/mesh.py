"""Device mesh construction.

The reference scales by running N independent executor processes, one task
per partition. The mesh stages run one stage over a mesh instead:
partitions map to mesh shards, exchanges to collectives between them.

A mesh here is an ordered array of torch.devices with axis names (what
jax.sharding.Mesh is to the JAX package), plus the process rank that owns
each shard. Devices may repeat: [torch.device("cpu")] * 4 is a four-shard
mesh on the CPU (the tests' stand-in for the JAX package's forced host
devices), and [torch.device("cuda")] * 4 a four-shard mesh on one card.
Under an initialized torch.distributed process group every process passes
its own local devices, and the global mesh lists them in rank order, as
jax.devices() orders a pod's devices by process.

The JAX package's meshcompat.py has no counterpart: it is a shim between
two jax versions' shard_map signatures, and this package calls no
shard_map.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ballista_tpu_torch.errors import DeviceError


class Mesh:
    """Shards in flat order: `devices` (an object array shaped by the axis
    sizes), `shape` (axis name -> size), `ranks` (the process rank owning
    each flat shard)."""

    def __init__(self, devices: Sequence, shape: Dict[str, int],
                 ranks: Sequence[int]) -> None:
        flat = np.empty(len(devices), dtype=object)
        flat[:] = list(devices)
        self.devices = flat.reshape(tuple(shape.values()))
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.ranks = tuple(int(r) for r in ranks)

    @property
    def size(self) -> int:
        return len(self.ranks)

    def flat_devices(self) -> List[object]:
        return list(self.devices.flat)


def default_devices(device=None) -> list:
    """The devices a mesh spans when the caller names none: every CUDA
    device for a CUDA (or unnamed) device; the given device alone
    otherwise. Without CUDA and without a device it raises: a mesh never
    lands on the CPU unless the caller asks for it."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return [torch.device(device)]
    if not torch.cuda.is_available():
        raise DeviceError(
            "build_mesh: CUDA is not available; pass devices= (for example "
            "[torch.device('cpu')] * 4) to build a mesh on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(shape: Optional[Dict[str, int]] = None, devices=None) -> Mesh:
    """Build a Mesh. shape e.g. {"data": 8}; defaults to every device on one
    'data' axis (row parallelism, a query engine's natural axis). `devices`
    are this process's devices (default: every CUDA device), repeats
    allowed; raises ValueError when the shape needs more shards than the
    processes have devices."""
    import torch

    from ballista_tpu_torch.parallel import multihost

    if devices is None:
        devices = default_devices()
    devices = [torch.device(d) for d in devices]
    world = multihost.process_count()
    ranks = [r for r in range(world) for _ in devices]
    if not shape:
        shape = {"data": len(ranks)}
    total = int(np.prod(list(shape.values())))
    if total > len(ranks):
        raise ValueError(f"mesh {shape} needs {total} devices, have {len(ranks)}")
    return Mesh((devices * world)[:total], shape, ranks[:total])
