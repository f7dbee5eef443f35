"""The port's benchmark entry: TPC-H rows, the NYC-taxi shapes and the
serving scenarios through ballista_tpu_torch, on the card unless the caller
asks for the CPU (`BENCH_DEVICE=cpu`, or `device="cpu"`).

    python -m ballista_tpu_torch.bench            # the whole list, one JSON line
    python -m ballista_tpu_torch.bench.runner ... # the TPC-H CLI
    python -m ballista_tpu_torch.bench.compare ...# the cross-engine check

It follows bench.py's layout and function names (`data`, `snapshots`,
`tpch`, `taxi`, `scenarios/`) so that each piece has a counterpart there;
unlike bench.py it holds every timed answer against the port's "cpu"
backend, and a failed config or scenario fails the run.
"""

import os


def bench_device(device=None) -> str:
    """The device the bench runs on: the argument, else BENCH_DEVICE, else
    "cuda"."""
    return device or os.environ.get("BENCH_DEVICE", "cuda")


def device_arg(device=None):
    """What the port's contexts and clusters take as `device=`: None for the
    card (so that a missing card raises there), else the device named."""
    d = bench_device(device)
    return None if d == "cuda" else d


def synchronize(device=None) -> None:
    """Wait for the card's queued work, so that a timer stops after it."""
    if bench_device(device) == "cuda":
        import torch

        torch.cuda.synchronize()
