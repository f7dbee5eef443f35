from ballista_tpu_torch.physical.plan import (  # noqa: F401
    ExecutionPlan,
    Partitioning,
    TaskContext,
)
