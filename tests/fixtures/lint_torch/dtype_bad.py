# ballista-lint: path=ballista_tpu_torch/ops/fixture_dtype_bad.py
"""BAD: float64 reaching a device transfer — a float64 tensor moved with
.to(device), a .double() moved with .cuda(), an np.float64 array through
runtime.upload, and a transfer that names float64 itself."""
import numpy as np
import torch

from ballista_tpu_torch.ops.runtime import upload


def move_wide(col, device):
    wide = torch.as_tensor(col, dtype=torch.float64)
    return wide.to(device)  # f64 crosses h2d


def move_double(t):
    return t.double().cuda()


def upload_wide(col, device):
    return upload(col.astype(np.float64), device)


def tensor_on_device(col, device):
    return torch.as_tensor(col, device=device, dtype=torch.double)
