# ballista-lint: path=ballista_tpu_torch/ops/fixture_suppress_noreason.py
"""A suppression without a reason does not suppress AND is itself flagged."""
import torch


def peek(x):
    n = torch.count_nonzero(x)
    return n.item()  # ballista-lint: disable=readback-discipline
