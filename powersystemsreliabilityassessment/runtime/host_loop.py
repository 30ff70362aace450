"""Double-buffered host dispatch loop with grow-and-redo.

All three MCS studies (hl2_nsq / hl2_seq / hl2_seq_split) drive their
jitted batch step from the same host loop: dispatch batch ``k+1``
*before* synchronizing on batch ``k``'s (tiny) partial sums, so the
host<->device round-trip hides behind device compute — the
replacement for the reference's ``parfor`` worker pool (nsqMain.m:257,
seqMain.m:112). The convergence check therefore lags one batch: at most
one extra batch of work, which is consumed, not discarded.

The loop also owns the adaptive LP-buffer "grow and REDO" protocol:
``consume`` may report that a finished batch overflowed its compaction
buffer after rebuilding the step with a doubled buffer; since batch keys
are deterministic in the batch index, re-dispatching the same index is
an exact redo, not a resample — estimates are invariant to the initial
buffer size (pinned by test_nsq_adaptive_lp_buffer_redo_exact /
test_seq_adaptive_lp_buffer).
"""
from __future__ import annotations

from typing import Any, Callable


def double_buffered_loop(dispatch: Callable[[int], Any],
                         consume: Callable[[Any, int], bool],
                         should_continue: Callable[[int], bool],
                         start_idx: int = 0) -> int:
    """Run the double-buffered dispatch/consume loop.

    ``dispatch(i)``
        Launch batch ``i`` on the device and return its (async) outputs.
        Must be deterministic in ``i`` (fold the PRNG root with ``i``) so
        a redo reproduces the batch exactly. Reads the CURRENT step
        closure — a redo rebuilds it before this is called again.
    ``consume(out, next_idx)``
        Synchronize on a finished batch and fold it into the running
        statistics; return True iff the batch overflowed and must be
        redone (after ``consume`` itself rebuilt the step with a larger
        buffer). ``next_idx`` is the batch index a checkpoint written
        now should resume from (everything below it is folded in or
        about to be redone).
    ``should_continue(i)``
        Checked before dispatching batch ``i``; False stops dispatching
        (the in-flight batch is still drained and consumed).

    Returns the next undispatched batch index.
    """
    pending: tuple[int, Any] | None = None
    i = start_idx
    while should_continue(i):
        out = dispatch(i)
        if pending is not None and consume(pending[1], i):
            # Redo the overflowed batch with the grown buffer; the batch
            # just dispatched above used the old step, so rewind and
            # re-dispatch it next iteration.
            out = dispatch(pending[0])
            i = pending[0]
        pending = (i, out)
        i += 1
    # Drain the in-flight batch; if IT overflows, redo it too (dropping
    # it would lose its samples and break the grow-and-redo exactness).
    while pending is not None:
        if consume(pending[1], pending[0] + 1):
            pending = (pending[0], dispatch(pending[0]))
        else:
            pending = None
    return i


__all__ = ["double_buffered_loop"]
