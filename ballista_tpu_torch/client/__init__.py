from ballista_tpu_torch.client.context import BallistaContext, BallistaDataFrame  # noqa: F401
