# ballista-lint: path=ballista_tpu_torch/ops/fixture_suppress_ok.py
"""A reasoned suppression silences exactly its rule on its line."""
import torch


def peek(x):
    n = torch.count_nonzero(x)
    return n.item()  # ballista-lint: disable=readback-discipline -- fixture: a reviewed probe
