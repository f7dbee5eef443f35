# ballista-lint: path=ballista_tpu_torch/ops/fixture_readback_bad.py
"""BAD: device tensors materialized on the host with no readback
accounting — an unrecorded .item(), a .cpu().numpy(), a .tolist() of a
kernel wrapper's result, a host branch (bool()) on a device value, and
.item() and .cpu() of loop variables that run over device tensors."""
import torch

from ballista_tpu_torch.ops.cuda_kernels import sorted_grouped_sum


def count_rows(mask):
    n = torch.count_nonzero(mask)
    return n.item()  # unrecorded d2h transfer (a hidden sync)


def fetch(values, device):
    out = torch.zeros(values.shape[0], device=device)
    out += values
    return out.cpu().numpy()  # unrecorded d2h transfer


def kernel_sums(values, codes, n_groups):
    sums = sorted_grouped_sum(values, codes, n_groups)
    return sums.tolist()  # unrecorded d2h transfer


def any_hit(x):
    hits = torch.gt(x, 0)
    if bool(hits.any()):  # a host branch on a device value
        return 1
    return 0


def item_each(values, device):
    parts = [torch.as_tensor(v, device=device) for v in values]
    return [t.item() for t in parts]  # unrecorded d2h transfer


def gather_host(x):
    host = []
    for t in torch.split(x, 2):
        host.append(t.cpu())  # unrecorded d2h transfer
    return host
