"""runtime/host_loop.py: the shared double-buffered dispatch protocol.

Pure-host unit tests with a fake step — the study-level behavior
(estimates invariant to the initial LP buffer, checkpoint resume) is
pinned separately in test_parallel.py; these pin the loop contract
itself: every batch consumed exactly once, redo semantics, in-flight
drain, and the checkpoint resume index.
"""
from powersystemsreliabilityassessment.runtime.host_loop import (
    double_buffered_loop)


class Harness:
    def __init__(self, n_batches, overflow_until=None, overflow_idx=()):
        # overflow_until: buffer "size" below which any batch overflows;
        # grows by doubling like the studies' consume.
        self.n = n_batches
        self.buf = 1
        self.need = dict(overflow_until or {})
        self.overflow_idx = set(overflow_idx)
        self.dispatched = []
        self.consumed = []
        self.next_idxs = []

    def dispatch(self, i):
        self.dispatched.append((i, self.buf))
        return (i, self.buf)

    def consume(self, out, next_idx):
        i, buf = out
        self.next_idxs.append(next_idx)
        if buf < self.need.get(i, 0):
            self.buf *= 2          # "rebuild the step with a grown buffer"
            return True
        self.consumed.append(i)
        return False

    def run(self, start_idx=0):
        return double_buffered_loop(
            self.dispatch, self.consume,
            should_continue=lambda i: i < self.n, start_idx=start_idx)


def test_plain_run_consumes_every_batch_once_in_order():
    h = Harness(5)
    assert h.run() == 5
    assert h.consumed == [0, 1, 2, 3, 4]
    assert [d[0] for d in h.dispatched] == [0, 1, 2, 3, 4]
    # checkpoint resume index = consumed index + 1, always.
    assert h.next_idxs == [1, 2, 3, 4, 5]


def test_double_buffering_dispatches_ahead():
    # Batch k+1 must be dispatched BEFORE batch k is consumed: with 2
    # batches the dispatch log is [0, 1] before any consume runs.
    order = []
    h = Harness(2)
    orig_d, orig_c = h.dispatch, h.consume
    h.dispatch = lambda i: (order.append(("d", i)), orig_d(i))[1]
    h.consume = lambda o, n: (order.append(("c", o[0])), orig_c(o, n))[1]
    h.run()
    assert order == [("d", 0), ("d", 1), ("c", 0), ("c", 1)]


def test_midloop_overflow_redoes_exactly():
    # Batch 1 needs buf >= 4 (two growths). The loop must re-dispatch
    # batch 1 (and the batch that was in flight with the stale step)
    # until it fits, and consume every index exactly once.
    h = Harness(4, overflow_until={1: 4})
    h.run()
    assert h.consumed == [0, 1, 2, 3]
    assert h.buf == 4
    # batch 1 dispatched with buf 1, 2 and 4; later batches only with 4.
    bufs = {i: [b for j, b in h.dispatched if j == i] for i in range(4)}
    assert bufs[1] == [1, 2, 4]
    assert bufs[3] == [4]


def test_final_inflight_overflow_is_redone_not_dropped():
    # The LAST batch overflows: the drain must redo it with the grown
    # buffer, not drop it.
    h = Harness(3, overflow_until={2: 2})
    h.run()
    assert h.consumed == [0, 1, 2]
    assert [b for j, b in h.dispatched if j == 2] == [1, 2]
    # resume index after the drained final batch is n.
    assert h.next_idxs[-1] == 3


def test_start_idx_resume():
    h = Harness(6)
    assert h.run(start_idx=4) == 6
    assert h.consumed == [4, 5]


def test_zero_batches():
    h = Harness(0)
    assert h.run() == 0
    assert h.consumed == [] and h.dispatched == []
