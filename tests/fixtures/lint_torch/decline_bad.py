# ballista-lint: path=ballista_tpu_torch/ops/fixture_decline_bad.py
"""BAD: reasonless decline, silent None decline, ad-hoc bail."""


class UnsupportedOnDevice(Exception):
    pass


def lower(col):
    if col is None:
        raise UnsupportedOnDevice()  # no reason
    if not hasattr(col, "dtype"):
        raise RuntimeError("can't lower")  # ad-hoc bail
    return col


def entry(col):
    try:
        return lower(col)
    except UnsupportedOnDevice:
        return None  # silent decline


def record_routing(engine, op):
    pass


def mesh_entry(ctx, run_mesh, run_host):
    try:
        out = run_mesh(ctx)
    except UnsupportedOnDevice:
        record_routing("host", "mesh.agg")  # the host route, but no reason
        yield from run_host(ctx)
        return  # silent decline
    yield out
