"""Cluster-state KV backends.

The reference abstracts all scheduler state behind a KV trait with two
implementations — etcd (distributed) and sled (embedded) — plus a global
lock (reference rust/scheduler/src/state/mod.rs:46-59, etcd.rs, standalone.rs).
Here:

- MemoryBackend: in-process dict (tests, --local mode)
- SqliteBackend: embedded durable store (the sled role; sqlite3 is the
  native embedded engine shipped with CPython)
- EtcdBackend: stub that activates only if a python etcd client is present
  (none is baked into this image; the trait boundary is what matters)

Leases: keys may carry an expiry; expired keys are invisible to get/scan
(the reference gives executor registrations a 60s lease, state/mod.rs:42).
"""

from __future__ import annotations

import contextlib
import os
import sqlite3
import time

from ballista_tpu_torch.utils.locks import make_rlock
from typing import Dict, Iterator, List, Optional, Tuple


class KvBackend:
    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def get_prefix(self, prefix: str) -> List[Tuple[str, bytes]]:
        raise NotImplementedError

    def put(self, key: str, value: bytes, lease_seconds: Optional[float] = None) -> None:
        raise NotImplementedError

    def put_all(
        self,
        items: List[Tuple[str, bytes]],
        *,
        compare: Optional[Tuple[str, Optional[bytes]]] = None,
        leases: Optional[List[Tuple[str, bytes, float]]] = None,
    ) -> bool:
        """Atomic multi-put: either every (key, value) lands or none does —
        the crash-safe publish seam for multi-key writes (a job's planning
        output must never be half-visible, ISSUE 6). Backends without real
        transactions must still make the batch all-or-nothing under the
        global lock.

        ISSUE 20 extensions for the replicated control plane:
        - `compare=(key, expected)` turns the batch into a fenced
          compare-and-swap: the batch lands only while `key`'s live value
          equals `expected` (`expected=None` means the key must be ABSENT);
          on mismatch nothing is written and the call returns False. This
          is the fencing rule — a deposed job owner's remembered lease
          value no longer matches, so its stale writes are rejected whole.
        - `leases=[(key, value, ttl_seconds)]` rides TTL-carrying writes in
          the same atomic batch (a job's ownership lease is minted with the
          planning commit, never beside it).

        Returns True when the batch landed."""
        raise NotImplementedError

    # -- lease primitives (ISSUE 20) ------------------------------------
    def lease_grant(self, key: str, value: bytes, ttl_seconds: float) -> None:
        """Write `key` with a TTL: invisible to get/scan after expiry
        unless renewed. Equivalent to put(..., lease_seconds=ttl) on
        embedded backends; etcd mints a real lease handle."""
        self.put(key, value, lease_seconds=ttl_seconds)

    def lease_renew(self, key: str, ttl_seconds: float) -> bool:
        """Extend a live leased key's expiry, preserving its value. Returns
        False when the key is missing or already expired — the caller has
        been deposed and must NOT write as if it still held the lease."""
        raise NotImplementedError

    def delete(self, key: str) -> None:
        """Delete exactly `key`. NOT delete_prefix(key): ledger keys like
        assignments/j/1/2 are string prefixes of assignments/j/1/20."""
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> None:
        raise NotImplementedError

    @contextlib.contextmanager
    def lock(self) -> Iterator[None]:
        """Global scheduler lock (ref /ballista_global_lock)."""
        raise NotImplementedError


class MemoryBackend(KvBackend):
    def __init__(self) -> None:
        self._data: Dict[str, Tuple[bytes, Optional[float]]] = {}  # guarded-by: self._mu
        self._mu = make_rlock("scheduler.kv.lock")

    # holds-lock: self._mu
    def _live(self, key: str) -> Optional[bytes]:
        item = self._data.get(key)
        if item is None:
            return None
        value, expires = item
        if expires is not None and time.time() > expires:
            del self._data[key]
            return None
        return value

    def get(self, key: str) -> Optional[bytes]:
        with self._mu:
            return self._live(key)

    def get_prefix(self, prefix: str) -> List[Tuple[str, bytes]]:
        with self._mu:
            out = []
            for k in sorted(self._data):
                if k.startswith(prefix):
                    v = self._live(k)
                    if v is not None:
                        out.append((k, v))
            return out

    def put(self, key: str, value: bytes, lease_seconds: Optional[float] = None) -> None:
        with self._mu:
            expires = time.time() + lease_seconds if lease_seconds else None
            self._data[key] = (value, expires)

    def put_all(
        self,
        items: List[Tuple[str, bytes]],
        *,
        compare: Optional[Tuple[str, Optional[bytes]]] = None,
        leases: Optional[List[Tuple[str, bytes, float]]] = None,
    ) -> bool:
        # validate the whole batch before touching the dict so a bad item
        # cannot leave a partial write behind
        staged = [(k, (v, None)) for k, v in items]
        for k, v, ttl in leases or ():
            float(ttl)
        with self._mu:
            if compare is not None and self._live(compare[0]) != compare[1]:
                return False
            now = time.time()
            self._data.update(staged)
            self._data.update(
                (k, (v, now + ttl)) for k, v, ttl in leases or ()
            )
            return True

    def lease_renew(self, key: str, ttl_seconds: float) -> bool:
        with self._mu:
            value = self._live(key)
            if value is None:
                return False
            self._data[key] = (value, time.time() + ttl_seconds)
            return True

    def delete(self, key: str) -> None:
        with self._mu:
            self._data.pop(key, None)

    def delete_prefix(self, prefix: str) -> None:
        with self._mu:
            for k in [k for k in self._data if k.startswith(prefix)]:
                del self._data[k]

    @contextlib.contextmanager
    def lock(self) -> Iterator[None]:
        with self._mu:
            yield


class SqliteBackend(KvBackend):
    """Durable embedded store (the reference's sled role). A restarted
    scheduler process resumes from the same DB file."""

    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._path = path
        self._mu = make_rlock("scheduler.kv.lock")
        # one shared connection, serialized by self._mu (sqlite3 objects are
        # not thread-safe under check_same_thread=False without it)
        self._conn = sqlite3.connect(path, check_same_thread=False)  # guarded-by: self._mu
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv ("
            "key TEXT PRIMARY KEY, value BLOB NOT NULL, expires REAL)"
        )
        self._conn.commit()

    @classmethod
    def temporary(cls) -> "SqliteBackend":
        """In-memory sqlite for tests (ref StandaloneClient::try_new_temporary)."""
        obj = cls.__new__(cls)
        obj._path = ":memory:"
        obj._mu = make_rlock("scheduler.kv.lock")
        obj._conn = sqlite3.connect(":memory:", check_same_thread=False)
        obj._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv ("
            "key TEXT PRIMARY KEY, value BLOB NOT NULL, expires REAL)"
        )
        obj._conn.commit()
        return obj

    def get(self, key: str) -> Optional[bytes]:
        with self._mu:
            row = self._conn.execute(
                "SELECT value, expires FROM kv WHERE key = ?", (key,)
            ).fetchone()
            if row is None:
                return None
            value, expires = row
            if expires is not None and time.time() > expires:
                self._conn.execute("DELETE FROM kv WHERE key = ?", (key,))
                self._conn.commit()
                return None
            return value

    def get_prefix(self, prefix: str) -> List[Tuple[str, bytes]]:
        with self._mu:
            rows = self._conn.execute(
                "SELECT key, value, expires FROM kv WHERE key >= ? AND key < ? ORDER BY key",
                (prefix, prefix + "￿"),
            ).fetchall()
            now = time.time()
            out = []
            for k, v, exp in rows:
                if exp is not None and now > exp:
                    continue
                out.append((k, v))
            return out

    def put(self, key: str, value: bytes, lease_seconds: Optional[float] = None) -> None:
        with self._mu:
            expires = time.time() + lease_seconds if lease_seconds else None
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (key, value, expires) VALUES (?, ?, ?)",
                (key, value, expires),
            )
            self._conn.commit()

    def put_all(
        self,
        items: List[Tuple[str, bytes]],
        *,
        compare: Optional[Tuple[str, Optional[bytes]]] = None,
        leases: Optional[List[Tuple[str, bytes, float]]] = None,
    ) -> bool:
        # one sqlite transaction: a crash (or a bad item) mid-batch rolls
        # the whole publish back — this is the backend-transaction form of
        # the ISSUE 6 all-or-nothing planning write. The fenced compare
        # reads under the same lock+transaction, so the check-then-write
        # is atomic against every other writer of this store.
        with self._mu:
            try:
                if compare is not None:
                    ckey, expected = compare
                    row = self._conn.execute(
                        "SELECT value, expires FROM kv WHERE key = ?", (ckey,)
                    ).fetchone()
                    current = None
                    if row is not None:
                        value, exp = row
                        if exp is None or time.time() <= exp:
                            current = bytes(value)
                    if current != expected:
                        self._conn.rollback()
                        return False
                self._conn.executemany(
                    "INSERT OR REPLACE INTO kv (key, value, expires) "
                    "VALUES (?, ?, NULL)",
                    items,
                )
                if leases:
                    now = time.time()
                    self._conn.executemany(
                        "INSERT OR REPLACE INTO kv (key, value, expires) "
                        "VALUES (?, ?, ?)",
                        [(k, v, now + ttl) for k, v, ttl in leases],
                    )
                self._conn.commit()
                return True
            except BaseException:
                self._conn.rollback()
                raise

    def lease_renew(self, key: str, ttl_seconds: float) -> bool:
        with self._mu:
            now = time.time()
            cur = self._conn.execute(
                "UPDATE kv SET expires = ? WHERE key = ? "
                "AND (expires IS NULL OR expires > ?)",
                (now + ttl_seconds, key, now),
            )
            self._conn.commit()
            return cur.rowcount > 0

    def delete(self, key: str) -> None:
        with self._mu:
            self._conn.execute("DELETE FROM kv WHERE key = ?", (key,))
            self._conn.commit()

    def delete_prefix(self, prefix: str) -> None:
        with self._mu:
            self._conn.execute(
                "DELETE FROM kv WHERE key >= ? AND key < ?",
                (prefix, prefix + "￿"),
            )
            self._conn.commit()

    @contextlib.contextmanager
    def lock(self) -> Iterator[None]:
        with self._mu:
            yield


class EtcdBackend(KvBackend):
    """Distributed backend over etcd's v3 API. Activates only when a python
    etcd3 client library is importable; the image ships none, so multi-
    scheduler HA deployments bring their own (the trait is the contract)."""

    def __init__(self, endpoints: str) -> None:
        try:
            import etcd3  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "etcd backend requires the 'etcd3' package; "
                "use MemoryBackend or SqliteBackend instead"
            ) from e
        host, _, port = endpoints.partition(":")
        self._client = etcd3.client(host=host, port=int(port or 2379))
        self._lock_name = "/ballista_global_lock"
        # lease handles this client granted, keyed by the key they guard:
        # etcd renews through the handle (keepalive), not through the key
        self._leases: Dict[str, object] = {}

    def get(self, key: str) -> Optional[bytes]:
        value, _ = self._client.get(key)
        return value

    def get_prefix(self, prefix: str) -> List[Tuple[str, bytes]]:
        return [
            (meta.key.decode(), value)
            for value, meta in self._client.get_prefix(prefix, sort_order="ascend")
        ]

    def put(self, key: str, value: bytes, lease_seconds: Optional[float] = None) -> None:
        # etcd leases are whole seconds with a 1s minimum; round up so a
        # sub-second lease never truncates to "no expiry"
        import math

        lease = (
            self._client.lease(max(1, math.ceil(lease_seconds)))
            if lease_seconds
            else None
        )
        self._client.put(key, value, lease=lease)

    # etcd rejects transactions above --max-txn-ops (default 128); a plan
    # batch beyond it cannot be published atomically on a default server
    MAX_TXN_OPS = 128

    def put_all(
        self,
        items: List[Tuple[str, bytes]],
        *,
        compare: Optional[Tuple[str, Optional[bytes]]] = None,
        leases: Optional[List[Tuple[str, bytes, float]]] = None,
    ) -> bool:
        # etcd v3 transaction; the fenced form compares the guard key's
        # live VALUE (version==0 for expect-absent) in the same txn, which
        # is exactly etcd's native compare-and-swap
        import math

        n = len(items) + len(leases or ())
        if n > self.MAX_TXN_OPS:
            # fail LOUDLY instead of letting the server reject with an
            # opaque error (or silently splitting and losing atomicity):
            # the deployment must raise --max-txn-ops to plan jobs with
            # this many stages x partitions
            raise RuntimeError(
                f"atomic batch of {n} keys exceeds etcd's default "
                f"max-txn-ops ({self.MAX_TXN_OPS}); raise --max-txn-ops on "
                "the etcd server (and MAX_TXN_OPS here) or reduce "
                "ballista.shuffle.partitions"
            )
        compares = []
        if compare is not None:
            ckey, expected = compare
            if expected is None:
                compares = [self._client.transactions.version(ckey) == 0]
            else:
                compares = [self._client.transactions.value(ckey) == expected]
        ops = [self._client.transactions.put(k, v) for k, v in items]
        for k, v, ttl in leases or ():
            handle = self._client.lease(max(1, math.ceil(ttl)))
            self._leases[k] = handle
            ops.append(self._client.transactions.put(k, v, lease=handle))
        ok, _responses = self._client.transaction(
            compare=compares, success=ops, failure=[]
        )
        return bool(ok)

    def lease_grant(self, key: str, value: bytes, ttl_seconds: float) -> None:
        import math

        handle = self._client.lease(max(1, math.ceil(ttl_seconds)))
        self._leases[key] = handle
        self._client.put(key, value, lease=handle)

    def lease_renew(self, key: str, ttl_seconds: float) -> bool:
        current = self.get(key)
        if current is None:
            # expired (or never ours): the handle, if any, is dead weight
            self._leases.pop(key, None)
            return False
        handle = self._leases.get(key)
        if handle is not None:
            handle.refresh()
            return True
        # live key granted by another client (e.g. adopted after a peer
        # died mid-TTL): re-grant under a fresh lease, preserving the value
        self.lease_grant(key, current, ttl_seconds)
        return True

    def delete(self, key: str) -> None:
        self._client.delete(key)

    def delete_prefix(self, prefix: str) -> None:
        self._client.delete_prefix(prefix)

    @contextlib.contextmanager
    def lock(self) -> Iterator[None]:
        with self._client.lock(self._lock_name):
            yield
