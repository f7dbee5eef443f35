# ballista-lint: path=ballista_tpu_torch/ops/fixture_decline_good.py
"""GOOD: reasoned declines through the canonical signals, paired with a
routing observation so the routing counters see the host decision; a
handler that records the host route and the caught reason itself (the
mesh aggregate's and mesh join's shape) is not silent; a failure that
must not fall back raises the typed DeviceError."""

from ballista_tpu_torch.ops.kernels import host_fallback
from ballista_tpu_torch.ops.runtime import UnsupportedOnDevice, record_routing


def lower(col):
    if col is None:
        raise UnsupportedOnDevice("null column has no device representation")
    return col


def entry(col):
    try:
        return lower(col)
    except UnsupportedOnDevice as e:
        record_routing("host", "fixture")
        return host_fallback(f"fixture lowering: {e}")


def mesh_entry(ctx, run_mesh, run_host):
    from ballista_tpu_torch.ops.runtime import record_routing_reason

    try:
        out = run_mesh(ctx)
    except UnsupportedOnDevice as e:
        record_routing_reason(f"mesh aggregate: {e}")
        record_routing("host", "mesh.agg")
        yield from run_host(ctx)
        return  # rule adapted: the host route and the caught reason are recorded
    yield out


def load_kernel(path):
    from ballista_tpu_torch.errors import DeviceError

    if path is None:
        raise DeviceError("kernel library was not built")
    return path
