"""Convenience re-exports (the reference's prelude, rust/client/src/prelude.rs).

    from ballista_tpu_torch.prelude import *
"""

from ballista_tpu_torch.client import BallistaContext, BallistaDataFrame  # noqa: F401
from ballista_tpu_torch.client.flight import BallistaClient  # noqa: F401
from ballista_tpu_torch.config import BallistaConfig  # noqa: F401
from ballista_tpu_torch.engine import DataFrame, ExecutionContext  # noqa: F401
from ballista_tpu_torch.errors import BallistaError  # noqa: F401
from ballista_tpu_torch.logical import col, lit  # noqa: F401
from ballista_tpu_torch.logical.expr import functions  # noqa: F401

__all__ = [
    "BallistaContext",
    "BallistaDataFrame",
    "BallistaClient",
    "BallistaConfig",
    "DataFrame",
    "ExecutionContext",
    "BallistaError",
    "col",
    "lit",
    "functions",
]
