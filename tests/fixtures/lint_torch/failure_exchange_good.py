# ballista-lint: path=ballista_tpu_torch/executor/fixture_failure_exchange_good.py
"""GOOD: device-resident exchange chaos goes through the registered
literal ``exchange.evict`` site, keyed on the consumed piece's plan
coordinates + the CONSUMING attempt — a retried consumer draws a fresh
verdict, and an evicted entry only sends the reader down the authoritative
piece ladder (bit-identical output, zero task retries)."""


def probe_registry(chaos, stage_id, map_partition, piece, attempt):
    return chaos.should_inject(
        "exchange.evict",
        f"{stage_id}/{map_partition}/piece{piece}@a{attempt}",
    )
