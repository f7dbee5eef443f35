"""Entry point: python -m perfbench (see perfbench/run.py)."""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from perfbench.run import main

    raise SystemExit(main(t_start=T_START))
