"""Background compaction: flushes and merges off the insert hot path.

The synchronous engine does flush → merge-cascade inline in ``insert``, so
a big BTP merge stalls every caller (the very stall the paper's streaming
claim is about).  :class:`Compactor` moves that work to one worker
thread, following the direction of ParIS/MESSI (*Data Series Indexing
Gone Parallel*): inserts only append to the in-memory buffer, queries
read immutable snapshots, and the worker retires compaction debt one
unit at a time:

    1. a full buffer head  -> build a level-0 run, publish it atomically;
    2. else one merge from the leveling policy (pp: collapse-to-one,
       btp: ratio-r) — ``merge_trees`` runs outside the engine lock,
       the run-list swap inside it;
    3. else, if runs changed, mark them committed (the durable commit
       comes with the on-disk store).

The worker's kernels (``fused_build`` or ``zorder``, the merge's sort)
go to the default CUDA stream, the one the searching threads use too,
and the engine waits for them before it publishes a run — so a
snapshot's search, queued after the publish, only ever reads finished
tensors.

Scheduling is cooperative on the engine's condition variable: ``insert``
notifies after appending, and *waits* on the same condition while
:meth:`CoconutLSM.compaction_debt` exceeds ``max_debt`` — bounded
backpressure instead of an unbounded memory footprint when ingest outruns
compaction.  ``drain()`` is the synchronization point for ``flush()`` and
``close()``: it wakes the worker and blocks until every pending unit
(optionally including a forced flush of the partial buffer) has retired.

A worker exception is captured, parked on :attr:`error`, and re-raised on
the next ``insert``/``flush``/``close`` — ingest fails loudly rather than
silently accumulating unflushed data.  The thread is a daemon, so a
process exiting without ``close()`` never hangs on join.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from ..obs import get_registry, span as _span

__all__ = ["Compactor"]


class Compactor:
    """One worker thread retiring an engine's compaction debt."""

    def __init__(self, engine):
        self._engine = engine
        self._cv = engine._cv          # condition on the engine lock
        self._stop = False
        self._drain_req = 0            # monotonically increasing tickets
        self._drain_done = 0
        self._force_until = 0          # highest ticket requiring force
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._loop, name="coconut-compactor", daemon=True)
        self._thread.start()

    # -------------------------------------------------------------- interface
    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def check(self) -> None:
        """Re-raise a parked worker failure on the caller's thread."""
        if self.error is not None:
            raise RuntimeError("compactor thread failed") from self.error

    def notify(self) -> None:
        with self._cv:
            self._cv.notify_all()

    def drain(self, *, force: bool = True) -> None:
        """Block until all currently-pending compaction debt has retired.

        ``force=True`` additionally flushes the partial buffer (the
        semantics of a synchronous ``flush()``), leaving the engine fully
        flushed, merged, and committed on return.
        """
        with self._cv:
            self._drain_req += 1
            ticket = self._drain_req
            if force:                  # per-ticket, so a concurrent
                self._force_until = ticket   # force=False drain (e.g.
                # close()) cannot clobber an in-flight flush()'s request
            self._cv.notify_all()
            while (self._drain_done < ticket and self.error is None
                   and self._thread.is_alive()):
                self._cv.wait(timeout=1.0)
        self.check()
        if self._drain_done < ticket:
            raise RuntimeError("compactor thread died mid-drain")

    def stop(self, *, drain: bool = True) -> None:
        """Deterministic shutdown: optionally retire pending debt, then
        join the worker.  Idempotent."""
        if drain and self._thread.is_alive() and self.error is None:
            self.drain(force=False)
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=60.0)
        self.check()

    # ------------------------------------------------------------ worker loop
    def _pending_drain(self) -> bool:
        return self._drain_req > self._drain_done

    def _loop(self) -> None:
        eng = self._engine
        try:
            while True:
                with self._cv:
                    while True:
                        if self._stop:
                            return
                        force = self._force_until > self._drain_done
                        if eng._bg_work_pending(force):
                            break
                        if self._pending_drain():
                            self._drain_done = self._drain_req
                            self._cv.notify_all()
                            continue   # re-check: a stop may follow
                        self._cv.wait()
                # one retired unit = one span on the compactor's own
                # trace track (worker threads get their own tid), with
                # the debt level it left behind
                t0 = time.perf_counter()
                with _span("compact.bg_step", force=force) as sp:
                    eng._bg_step(force=force)
                    sp.set(debt_after=eng.compaction_debt())
                get_registry().histogram("compact.bg_step_ms").observe(
                    (time.perf_counter() - t0) * 1e3)
                with self._cv:
                    self._cv.notify_all()    # backpressured inserters, drains
                self._notify_external()      # sharded router's shared budget
        except BaseException as e:           # park for the foreground thread
            self.error = e
            with self._cv:
                self._drain_done = self._drain_req
                self._cv.notify_all()
            self._notify_external()

    def _notify_external(self) -> None:
        """Poke the engine's optional external debt condition — the
        sharded router's shared backpressure budget waits on it."""
        cv = getattr(self._engine, "debt_cv", None)
        if cv is not None:
            with cv:
                cv.notify_all()
