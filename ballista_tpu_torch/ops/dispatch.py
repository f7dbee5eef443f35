"""Backend dispatch: route operator compute to the device kernels.

The hook returns None when the device path declines the shape (the operator
then runs its host Arrow path). An import failure is not a decline: it
raises.
"""

from __future__ import annotations

from typing import Optional

import pyarrow as pa


def device_filter(batch: pa.RecordBatch, predicate, ctx) -> Optional[pa.RecordBatch]:
    from ballista_tpu_torch.ops import kernels

    return kernels.filter_batch(batch, predicate, ctx.device)


def device_hash_aggregate(exec_node, partition: int, ctx) -> Optional[pa.Table]:
    from ballista_tpu_torch.ops import kernels
    from ballista_tpu_torch.utils import tracing

    with tracing.span("stage.run"):
        return kernels.hash_aggregate(exec_node, partition, ctx)
