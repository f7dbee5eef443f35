"""ballista-lint for the PyTorch port: an AST checker of the conventions
``ballista_tpu_torch`` relies on and the interpreter cannot check
(`python -m ballista_tpu_torch.analysis`; default scope: the package
without this subpackage).

- **readback-discipline** — in ``ops/`` and ``parallel/``, a device tensor
  (the result of a ``torch.*`` call, of a kernel wrapper or of a device
  step) materialized on the host (``.cpu()``, ``.numpy()``, ``.item()``,
  ``.tolist()``, ``bool()``, ``int()``, ``float()``) must pair with
  ``record_readback`` in the same function or go through
  ``runtime.readback``; otherwise ``readback_stats()`` undercounts, and a
  host branch on a device value is a hidden sync.
- **dtype-discipline** — a float64 value (``torch.float64``,
  ``torch.double``, ``.double()``, ``np.float64``) must not reach a device
  transfer (``torch.as_tensor(..., device=)``, ``.to(device)``,
  ``.cuda()``, ``runtime.upload``, ``make_sharded``); ops/floatbits.py's
  order-preserving bijections are exempt.
- **guarded-by** — state registered with ``# guarded-by: <lock>`` is only
  touched inside ``with <lock>:`` (or in a function annotated
  ``# holds-lock: <lock>``, whose callers are checked instead).
- **decline-discipline** — device paths leave for the host only through
  ``raise UnsupportedOnDevice("<reason>")`` or the ``ops/kernels.py``
  helpers; a handler that swallows a decline must count it; ad-hoc
  ``Exception``/``RuntimeError``/``NotImplementedError`` raises are not
  decline channels (a failure that must not fall back raises
  ``errors.DeviceError``).
- **routing-discipline** / **failure-discipline** — tier routing and
  retry/requeue conventions; see their module docstrings.
- **lock-order** (``rules_lockorder.py`` + ``lockgraph.py`` +
  ``lockorder.toml``) — the whole-program acquired-while-held graph,
  deadlock cycles, the declared order, check-then-act across a release,
  and ``--check-witness`` (per-process ``<OUT>.<pid>`` dumps of
  ``utils/locks.py``'s runtime witness are merged and held against the
  static graph).
- **durability** (``rules_durability.py`` + ``durability.toml``) — every
  attribute of the scheduler's state classes carries
  ``# durability: durable(<kv-prefix>) | derived(<rebuild-fn>) |
  ephemeral(<reason>)`` in agreement with the manifest.

The JAX package's tracer-hygiene rule has no counterpart: eager PyTorch
has no tracers, and a host branch on a device value is a readback.

Suppression syntax (a reason is mandatory, checked by the always-on
`lint-usage` meta rule):

    something_flagged()  # ballista-lint: disable=<rule> -- <reason>

A standalone suppression comment covers the following line. Fixture files
opt into package scoping with a header comment
`# ballista-lint: path=ballista_tpu_torch/ops/<virtual>.py`.

Standard library only (ast, tokenize, tomllib); per-file results are
cached on (mtime, size, analyzer hash) in .ballista_torch_lint_cache.json.
"""

from ballista_tpu_torch.analysis.core import RULE_NAMES, analyze_file, run_paths  # noqa: F401
