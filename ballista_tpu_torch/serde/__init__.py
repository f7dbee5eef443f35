from ballista_tpu_torch.serde.logical import (  # noqa: F401
    expr_to_proto,
    expr_from_proto,
    plan_to_proto,
    plan_from_proto,
)
