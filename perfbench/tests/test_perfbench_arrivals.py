"""The open loop's schedule: Poisson at the mix's rate, users by
activity rank, and the same schedule for the same seed."""
import numpy as np

from perfbench.harness.serve import arrivals

POPULAR = np.arange(1000)[::-1].copy()      # rank r -> user 999 - r
MIX = {"rate_per_s": 5000.0, "user_alpha": 1.2}


def test_rate_and_window():
    due, users = arrivals(MIX, 4.0, POPULAR, seed=2**31 + 9, stream=2)
    assert abs(len(due) - 20_000) < 5 * np.sqrt(20_000)
    assert np.all(np.diff(due) >= 0) and due[-1] < 4.0
    assert len(users) == len(due)


def test_same_seed_same_schedule_streams_differ():
    a = arrivals(MIX, 1.0, POPULAR, seed=7, stream=2)
    b = arrivals(MIX, 1.0, POPULAR, seed=7, stream=2)
    c = arrivals(MIX, 1.0, POPULAR, seed=7, stream=3)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[1][:100], c[1][:100])


def test_zipf_users_favour_the_most_active():
    _, users = arrivals(MIX, 4.0, POPULAR, seed=1, stream=2)
    top = np.mean(users == POPULAR[0])
    assert top > 0.15                       # rank 1 of Zipf(1.2) over 1,000
