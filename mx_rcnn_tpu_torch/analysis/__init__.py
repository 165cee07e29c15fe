"""Analysis of the port: the durability linter and its runtime twin,
and the lock sanitizer.

Counterpart of ``mx_rcnn_tpu/analysis/``:

* ``common.py`` — the ``Finding`` record, the reasoned-waiver protocol,
  import alias resolution and file iteration every linter shares;
* ``persistlint.py`` — durability hygiene over the durable-write
  surface (checkpoints, the snapshot writer, export stores, bulk shards,
  run records): every durable write must ride the tmp → fsync → rename
  → dir-fsync, manifest-last idiom of ``utils/checkpoint.py —
  _atomic_write``.  ``python -m mx_rcnn_tpu_torch.analysis.persistlint
  mx_rcnn_tpu_torch`` exits 0 on the port's tree;
* ``crashsim.py`` — persistlint's runtime twin: records a real commit
  workload's write ops, enumerates every crash state the persistence
  model allows and runs the real recovery paths against each
  (``tools/crashsim.py``);
* ``sanitizer.py`` — the opt-in lock sanitizer.

The JAX package's graphlint, threadlint, configlint, netlint and wire
fuzzer are not ported yet.

Import ``RULES`` / ``lint_paths`` from the tool modules directly (kept
out of this namespace so ``python -m`` does not double-load them).
"""
