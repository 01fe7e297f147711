"""The window's arithmetic on a fake clock."""

import pytest

from benchmark.harness.window import closed_loop, nearest_rank


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def run(durations, seconds, fail_at=()):
    clock = FakeClock()
    done = []

    def request(i):
        clock.t += durations(i)
        done.append(i)
        if i in fail_at:
            raise RuntimeError("broken request")

    return closed_loop(request, seconds, clock=clock), done


def test_window_ends_at_the_completion_that_crosses_and_counts_it():
    win, done = run(lambda i: 0.3, 1.0)
    # completions at 0.3, 0.6, 0.9, 1.2: the fourth crosses 1.0 and counts
    assert win.attempted == 4 == len(done)
    assert win.length == pytest.approx(1.2)
    assert win.time_per_request() == pytest.approx(0.3)
    assert sum(win.latencies()) == pytest.approx(win.length)


@pytest.mark.parametrize("where", [0, 5, 19])
def test_a_stall_moves_every_end_to_end_statistic(where):
    base, _ = run(lambda i: 0.1, 2.0)
    # a stall of 5 s in one request, anywhere: the mean per request moves
    stalled, _ = run(lambda i: 0.1 + (5.0 if i == where else 0.0), 2.0)
    assert stalled.time_per_request() > base.time_per_request()
    # stalls in a tenth of the requests move the 95th percentile
    slow, _ = run(lambda i: 0.1 + (0.5 if i % 10 == where % 10 else 0.0),
                  20.0)
    calm, _ = run(lambda i: 0.1, 20.0)
    assert slow.p95() > calm.p95()
    assert slow.time_per_request() > calm.time_per_request()


def test_a_stall_between_requests_lands_in_a_latency():
    clock = FakeClock()

    def request(i):
        if i == 3:
            clock.t += 2.0    # the host stalls before sending request 3
        clock.t += 0.1

    win = closed_loop(request, 1.0, clock=clock)
    assert max(win.latencies()) == pytest.approx(2.1)
    assert win.length == pytest.approx(sum(win.latencies()))


def test_streamed_rate_loses_no_granule_at_the_edge():
    # granules of 12.5 s in a 51 s window: the fifth crosses the edge and
    # counts whole, so the time per granule is exact
    win, _ = run(lambda i: 12.5, 51.0)
    assert win.attempted == 5
    assert win.time_per_request() == pytest.approx(12.5)


def test_failed_requests_count_as_attempted_not_completed():
    seen = []
    clock = FakeClock()

    def request(i):
        clock.t += 0.1
        if i == 2:
            raise RuntimeError("x")

    win = closed_loop(request, 0.5, clock=clock,
                      on_error=lambda i, e: seen.append(i))
    assert seen == [2] and win.failed == 1
    assert win.completed == win.attempted - 1
    assert win.time_per_request() == pytest.approx(win.length / win.completed)


def test_nearest_rank():
    vals = list(range(1, 101))
    assert nearest_rank(vals, 95.0) == 95
    assert nearest_rank([3.0], 95.0) == 3.0
    assert nearest_rank([1, 2], 95.0) == 2
