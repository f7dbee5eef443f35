# ballista-lint: path=ballista_tpu_torch/ops/fixture_dtype_good.py
"""GOOD: narrow before the transfer; post-readback host widening to
float64 is the documented result dtype and is not a violation."""
import numpy as np
import torch

from ballista_tpu_torch.ops.runtime import readback, upload


def move_narrow(col, device):
    return torch.as_tensor(col.astype(np.float32), device=device)


def move_cast(t, device):
    return t.to(torch.float32).to(device)


def upload_narrow(col, device):
    return upload(col.astype(np.float32), device)


def host_fold_after_readback(out):
    stacked = readback(out)
    return stacked.astype(np.float64)  # host-side result widening: fine
