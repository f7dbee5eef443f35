# ballista-lint: path=ballista_tpu_torch/scheduler/fixture_durability_good.py
"""GOOD: every attribute carries a durability classification; durable
mutations write through to the KV (directly, via the key helper, or
through a same-file helper); the derived index is rebuilt from
recover(); status folds consult the attempt guard or carry a reviewed
annotation; the ephemeral count stays within the default budget."""


class MiniLedger:
    def __init__(self, kv, namespace):
        self.kv = kv  # durability: ephemeral(the backend handle itself, not state)
        self.namespace = namespace  # durability: ephemeral(identity of this replica's keyspace)
        self._assigned = {}  # durability: durable(assignments)
        self._index = None  # durability: derived(_rebuild_index)

    def _key(self, *parts):
        return "/".join(("/ballista", self.namespace) + parts)

    def _ledger_key(self, task_id):
        return self._key("assignments", task_id)

    def _ledger_put(self, task_id, executor_id):
        self.kv.put(self._ledger_key(task_id), executor_id)

    def assign(self, task_id, executor_id):
        # write-through via the same-file helper (closure reachability)
        self._assigned[task_id] = executor_id
        self._ledger_put(task_id, executor_id)

    def unassign(self, task_id):
        # write-through directly against the declared prefix
        self._assigned.pop(task_id, None)
        self.kv.delete(self._key("assignments", task_id))

    def _rebuild_index(self):
        self._index = {}
        for key, executor_id in self.kv.get_prefix(
            self._key("assignments") + "/"
        ):
            self._index.setdefault(executor_id, []).append(key)

    def recover(self):
        # rebuild-from-KV: the prefix scan repopulates the durable map,
        # then warms the derived index
        self._assigned.clear()
        for key, executor_id in self.kv.get_prefix(
            self._key("assignments") + "/"
        ):
            self._assigned[key.rsplit("/", 1)[-1]] = executor_id
        self._rebuild_index()

    def accept_task_status(self, status):
        return status.attempt >= 0

    def fold_status(self, status):
        # consults the attempt/ledger guard before folding
        if self.accept_task_status(status):
            self.save_task_status(status)

    def save_task_status(self, status):
        self.kv.put(self._key("assignments", status.task_id), status.state)

    # attempt-guard-ok: replays a status the caller's guard already vetted
    def replay_status(self, status):
        self.save_task_status(status)
