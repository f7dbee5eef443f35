from ballista_tpu_torch.engine.context import ExecutionContext, DataFrame  # noqa: F401
