"""Analysis of the port: the concurrency, config and durability linters,
the durability linter's runtime twin, and the lock sanitizer.

Counterpart of ``mx_rcnn_tpu/analysis/``:

* ``common.py`` — the ``Finding`` record, the reasoned-waiver protocol,
  import alias resolution and file iteration every linter shares;
* ``threadlint.py`` — concurrency hygiene: the cross-module lock-order
  graph (cycles, self-deadlocks), unguarded shared state on thread
  paths, blocking calls under a lock (``torch.cuda.synchronize`` and a
  CUDA event's ``.synchronize()`` among them), signal-handler safety and
  the condition-variable protocol.  ``python -m
  mx_rcnn_tpu_torch.analysis.threadlint mx_rcnn_tpu_torch`` exits 0 on
  the port's tree; ``--graph`` dumps its lock graph;
* ``configlint.py`` — config-key hygiene against the port's
  ``config.py``: every ``cfg.<section>.<key>`` read names a declared
  key (CL101) and every declared key is read somewhere (CL201);
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
* ``sanitizer.py`` — the opt-in lock sanitizer, threadlint's runtime
  twin.

The JAX package's graphlint, netlint and wire fuzzer are not ported
yet.

Import ``RULES`` / ``lint_paths`` from the tool modules directly (kept
out of this namespace so ``python -m`` does not double-load them).
"""
