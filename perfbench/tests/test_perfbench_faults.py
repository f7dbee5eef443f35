"""`correct` comes out false when the timed path is broken: the control
(the reference in float32 in the program's place) and each fault a cell
can have, planted in the port underneath a whole run (the look for a card
skipped, the rest of the run as on the card, at a small size on the CPU).

The control needs a larger database than the faults: its gap grows with
the rows a group sums, and its reading at the cells' own sizes is in
PERF.md §2."""

import time

import pyarrow as pa
import pytest

from perfbench.control import ControlEngine
from perfbench.run import run_cell

HOT, ADHOC = "tpch-sf10-local.hot", "tpch-sf1-cluster.adhoc"


def _run(cell, tmp_path, sf=0.01, engine_cls=None, seconds=1.0):
    return run_cell(cell, 21, seconds, False, "cpu", time.perf_counter(), data_root=tmp_path,
                    sf=sf, engine_cls=engine_cls)


def _state_unchanged(mp):
    """The device stage returns its partial states as they start: zero."""
    from ballista_tpu_torch.ops import dispatch

    real = dispatch.device_hash_aggregate

    def step(node, partition, ctx):
        out = real(node, partition, ctx)
        if out is None:
            return None
        k = len(node.group_exprs)
        cols = [c if i < k else pa.array([0] * len(c), type=c.type)
                for i, c in enumerate(out.columns)]
        return pa.table(cols, schema=out.schema)

    # the aggregate operator imports it from dispatch at each call
    mp.setattr(dispatch, "device_hash_aggregate", step)


def _half_rows(mp):
    """Every Parquet scan leaves out the second half of each batch."""
    from ballista_tpu_torch.physical.scan import ParquetScanExec

    real = ParquetScanExec.execute

    def execute(self, partition, ctx):
        for b in real(self, partition, ctx):
            yield b.slice(0, b.num_rows // 2)

    mp.setattr(ParquetScanExec, "execute", execute)


def _no_exchange(mp):
    """A shuffle reader fetches the pieces of every other map task only."""
    from ballista_tpu_torch.distributed.stages import ShuffleReaderExec

    real = ShuffleReaderExec.execute

    def execute(self, partition, ctx):
        saved = self.locations
        if not self.identity and len(saved) > 1:
            self.locations = saved[::2]
        try:
            yield from real(self, partition, ctx)
        finally:
            self.locations = saved

    mp.setattr(ShuffleReaderExec, "execute", execute)


def _answer_altered(mp):
    """The final aggregate alters its first row's last value."""
    from ballista_tpu_torch.physical.aggregate import HashAggregateExec

    real = HashAggregateExec._final

    def final(self, table):
        out = real(self, table)
        if out.num_rows == 0:
            return out
        c = out.column(out.num_columns - 1).to_pylist()
        c[0] = c[0] * 1.001 if isinstance(c[0], float) else c[0] + 1
        return out.set_column(out.num_columns - 1, out.schema.field(out.num_columns - 1),
                              pa.array(c, type=out.schema.field(out.num_columns - 1).type))

    mp.setattr(HashAggregateExec, "_final", final)


def _later_keys_reversed(mp):
    """The final sort honours its first key only and reverses every later
    one: q1's (N, O) comes before (N, F), and each row is still right."""
    from ballista_tpu_torch.physical.basic import SortExec

    real = SortExec.execute

    def execute(self, partition, ctx):
        saved = self.sort_keys
        self.sort_keys = saved[:1] + [(e, not asc, nf) for e, asc, nf in saved[1:]]
        try:
            yield from real(self, partition, ctx)
        finally:
            self.sort_keys = saved

    mp.setattr(SortExec, "execute", execute)


FAULTS = {"state_unchanged": _state_unchanged, "half_rows": _half_rows,
          "answer_altered": _answer_altered, "later_keys_reversed": _later_keys_reversed,
          "no_exchange": _no_exchange}
CASES = [(HOT, f) for f in FAULTS if f != "no_exchange"] + [(ADHOC, f) for f in FAULTS]


def test_sound_runs_are_correct(tmp_path):
    for cell in (HOT, ADHOC):
        r = _run(cell, tmp_path)
        assert r["correct"], (cell, r["checks"])


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_in_the_timed_path_is_not_correct(cell, fault, tmp_path, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = _run(cell, tmp_path)
    print(cell, fault, r["checks"])
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", [HOT, ADHOC])
def test_the_control_is_not_correct(cell, tmp_path):
    r = _run(cell, tmp_path, sf=0.1, engine_cls=ControlEngine)
    assert not r["correct"], r["checks"]
    assert r["checks"]["rel_gap"]["value"] > r["checks"]["rel_gap"]["limit"]
