"""The window's rule against a stub job: whole jobs back to back, each
watched, closed by the first round of jobs that ends at or after the
window's seconds; and the round's seeds, the traffic's list in an order
drawn from the run's seed."""

from __future__ import annotations

import contextlib
import time

from portbench import run


class Watch:
    def __init__(self):
        self.entered = []

    def __call__(self, j):
        self.entered.append(j)
        return contextlib.nullcontext()


def _stub(durations, log):
    def job(j):
        log.append(j)
        time.sleep(durations[j])
        return j
    return job


def test_the_window_closes_after_the_job_that_crosses_it():
    log, watch = [], Watch()
    results, secs = run.run_window(_stub([0.05, 0.05, 0.05, 0.05], log), 0.12, watch,
                                   lambda: None)
    assert results == [0, 1, 2] and log == [0, 1, 2]
    assert 0.15 <= secs < 0.3
    assert watch.entered == [0, 1, 2]


def test_a_job_longer_than_the_window_is_not_cut():
    log = []
    results, secs = run.run_window(_stub([0.2, 0.2], log), 0.05, Watch(), lambda: None)
    assert results == [0] and secs >= 0.2


def test_a_zero_window_runs_one_job():
    results, _ = run.run_window(_stub([0.0, 0.0], []), 0.0, Watch(), lambda: None)
    assert results == [0]


def test_the_window_closes_only_at_the_end_of_a_round():
    log = []
    results, _ = run.run_window(_stub([0.05] * 6, log), 0.12, Watch(), lambda: None, 2)
    assert results == [0, 1, 2, 3]
    results, _ = run.run_window(_stub([0.2] * 4, []), 0.05, Watch(), lambda: None, 2)
    assert results == [0, 1]


def test_each_job_is_synchronized_before_the_clock_is_read():
    order = []

    def job(j):
        order.append(("job", j))
        return j

    run.run_window(job, 0.0, Watch(), lambda: order.append(("sync",)))
    assert order == [("job", 0), ("sync",)]


def test_every_seed_orders_the_same_jobs():
    traffic = {"job_seeds": [1, 2, 3]}
    orders = {tuple(run.job_seeds(traffic, s)) for s in (0, 5, 2**31 + 7, 2**33 + 1)}
    assert all(sorted(o) == [1, 2, 3] for o in orders) and len(orders) > 1
    assert run.job_seeds(traffic, 2**32 + 45) == run.job_seeds(traffic, 2**32 + 45)
