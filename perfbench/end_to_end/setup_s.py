"""Seconds from the start of the process to the window: CUDA context,
the database generated from the seed, the engine's start, registration
and the cold set-up queries."""

UNIT = "s"


def read(run: dict):
    return run["setup_s"]
