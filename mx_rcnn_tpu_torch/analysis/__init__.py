"""Analysis of the port: the concurrency, config, durability and network
linters, the durability and network linters' runtime twins, and the
lock sanitizer.

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
* ``netlint.py`` — network-surface hygiene over the cross-host plane:
  tracked socket/connection/response objects must be timed (NL101)
  and exception-safe (NL102), wire decodes length-checked (NL201)
  with every peer-supplied length bounded before it sizes an
  allocation (NL202), response/body reads byte-capped and
  deadline-bounded through ``netio`` (NL203/NL204), and retry loops
  backed off AND capped (NL301).  ``python -m
  mx_rcnn_tpu_torch.analysis.netlint`` exits 0 on the port's tree;
* ``wirefuzz.py`` — netlint's runtime twin: a deterministic seeded
  mutation engine, an allocation guard, a raw-HTTP client with
  byte-level delivery control and a socket-level fault proxy, which
  ``tools/wirefuzz.py`` aims at the real codecs, a live agent, a
  malicious metrics server and a faulted head-agent link;
* ``sanitizer.py`` — the opt-in lock sanitizer, threadlint's runtime
  twin.

The JAX package's graphlint is not ported: it audits XLA programs, and
the port captures no CUDA graph yet.

Import ``RULES`` / ``lint_paths`` from the tool modules directly (kept
out of this namespace so ``python -m`` does not double-load them).
"""
