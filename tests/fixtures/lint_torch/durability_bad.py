# ballista-lint: path=ballista_tpu_torch/scheduler/fixture_durability_bad.py
"""BAD: an unannotated attribute, a malformed prefix, a reasonless
ephemeral, a non-identifier rebuild, a conflicting reclassification, a
durable mutation with no KV write in scope, a guardless status fold, a
derived rebuild recover() never reaches, a dangling annotation, and an
over-budget ephemeral population."""


class LeakyLedger:
    def __init__(self, kv, namespace):
        self.kv = kv  # durability: ephemeral(backend handle)
        self.namespace = namespace  # durability: ephemeral(keyspace identity)
        self._orphan = 0
        self._assigned = {}  # durability: durable(assignments)
        self._ledger = {}  # durability: durable(bad prefix!)
        self._idx = None  # durability: derived(_rebuild_idx)
        self._view = None  # durability: derived(not an ident!)
        self._tmp = {}  # durability: ephemeral()
        self._hints = {}  # durability: ephemeral(scheduling hints)
        self._stats = {}  # durability: ephemeral(counters)
        self._notes = {}  # durability: ephemeral(advisory notes)
        self._seen = set()  # durability: ephemeral(dedup memory)

    def _key(self, *parts):
        return "/".join(("/ballista", self.namespace) + parts)

    def assign(self, task_id, executor_id):
        # durable mutation with no KV operation in the same scope
        self._assigned[task_id] = executor_id

    def reset(self):
        self._assigned = {}  # durability: ephemeral(cleared on reset)

    def _rebuild_idx(self):
        self._idx = dict(self.kv.get_prefix(self._key("assignments") + "/"))

    def recover(self):
        # never calls _rebuild_idx: the derived index stays cold forever
        for key, executor_id in self.kv.get_prefix(
            self._key("assignments") + "/"
        ):
            self._assigned[key.rsplit("/", 1)[-1]] = executor_id

    def fold_status(self, status):
        # folds an executor-reported status with no attempt guard
        self.save_task_status(status)

    def save_task_status(self, status):
        self.kv.put(self._key("assignments", status.task_id), status.state)


DANGLING_BEFORE = 1
# durability: ephemeral(floating annotation with no assignment)
DANGLING_AFTER = 2
