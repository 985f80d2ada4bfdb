"""The traffic generators turn a seed into the same inputs every time, and give
every seed the same work in another order."""

import numpy as np

from benchmark.traffic import batch_closed, poisson_stream

BATCH = {"batch": 8, "min_s": 1.0, "max_s": 2.0, "distinct_batches": 3}
STREAM = {"rate_per_s": 4.0, "slots": 8, "push_samples": 1024, "min_s": 1.0, "max_s": 2.0,
          "prefill_s": 2.0, "tape_s": 10.0}
BIG = 2 ** 31 + 12345  # seeds may pass 32 signed bits


def test_batch_deterministic():
    a, b = batch_closed.make(BATCH, BIG), batch_closed.make(BATCH, BIG)
    assert all(np.array_equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    c = batch_closed.make(BATCH, BIG + 1)
    assert not np.array_equal(a[0][0][:100], c[0][0][:100])


def test_batch_same_work_every_seed():
    def lengths(s):
        return [sorted(p.shape[0] for p in batch) for batch in batch_closed.make(BATCH, s)]

    assert lengths(1) == lengths(BIG)
    batch = batch_closed.make(BATCH, 5)[0]
    assert all(p.dtype == np.int16 and np.abs(p.astype(np.int64)).max() > 1000 for p in batch)


def test_stream_deterministic_and_same_work():
    a, b = poisson_stream.make(STREAM, BIG, 3.0), poisson_stream.make(STREAM, BIG, 3.0)
    assert [t for t, _ in a] == [t for t, _ in b]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))
    c = poisson_stream.make(STREAM, 7, 3.0)
    assert sorted(p.shape[0] for _, p in c) != [] and [t for t, _ in c] != [t for t, _ in a]
    assert a[0][0] == -STREAM["prefill_s"] and all(t < 3.0 for t, _ in a)
    gaps = np.diff([t for t, _ in a])
    assert abs(gaps.mean() - 1.0 / STREAM["rate_per_s"]) < 0.1
