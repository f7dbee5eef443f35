"""The serving scenarios of bench.py, each through the port's own cluster
on the card unless the caller asks for the CPU. Each returns its record
and raises where bench.py printed a failure and returned None."""


class ScenarioFailed(RuntimeError):
    """A scenario could not produce its record (a client failed or hung)."""


def digest_ipc(tbl) -> str:
    """sha256 of the table's Arrow IPC stream bytes (16 hex digits)."""
    import hashlib

    import pyarrow as pa

    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, tbl.schema) as w:
        w.write_table(tbl)
    return hashlib.sha256(sink.getvalue().to_pybytes()).hexdigest()[:16]


def digest_rows(tbl) -> str:
    """sha256 of the table's rows as Python values."""
    import hashlib

    return hashlib.sha256(repr(tbl.to_pydict()).encode()).hexdigest()
