# ballista-lint: path=ballista_tpu_torch/ops/fixture_readback_good.py
"""GOOD: both pairing styles — explicit record_readback, and the
runtime.readback helper; tensor metadata and numpy results are host data,
not readbacks, and so is a loop variable that runs over a numpy array."""
import numpy as np
import torch

from ballista_tpu_torch.ops.runtime import readback, record_readback


def count_rows(mask):
    n = torch.count_nonzero(mask).item()
    record_readback(1, 8)
    return n


def fetch(values, device):
    out = torch.zeros(values.shape[0], device=device)
    out += values
    return readback(out)


def sizes(x):
    t = torch.as_tensor(x)
    return int(t.shape[0]), t.numel(), int(t.size(0))


def host_only(codes):
    uniq, first = np.unique(codes, return_index=True)
    return dict(zip(uniq.tolist(), first.tolist()))


def item_each(values, device):
    parts = [torch.as_tensor(v, device=device) for v in values]
    out = [t.item() for t in parts]
    record_readback(len(out), 8 * len(out))
    return out


def gather_host(x):
    host = []
    for t in torch.split(x, 2):
        host.append(readback(t))
    return host


def host_loop(codes):
    return [c.item() for c in np.unique(codes)]
