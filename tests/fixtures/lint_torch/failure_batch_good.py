# ballista-lint: path=ballista_tpu_torch/scheduler/fixture_failure_batch_good.py
"""GOOD: shared-scan batch-formation chaos goes through the
registered literal site, keyed on the generation-rotated per-process
sequence (a torn formation degrades that dispatch to solo; the next
formation draws a fresh deterministic verdict)."""


def form_batch(chaos, generation, seq):
    chaos.maybe_fail("scheduler.batch", f"g{generation}/batch{seq}")
