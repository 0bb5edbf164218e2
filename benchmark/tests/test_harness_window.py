"""The window's arithmetic: the whole-sweep rate and p90 with its sample count."""

import statistics

from benchmark.harness import Window, p90, walker_sweeps_per_s


def _window(ends):
    return Window(t_open=ends[0], sweep_ends=list(ends), metadata={}, measured=len(ends), memory_peak=0, trace=None)


def test_rate_counts_whole_sweeps_over_their_time():
    win = _window([10.0, 10.5, 11.25, 12.0, 13.0])
    assert win.durations == [0.5, 0.75, 0.75, 1.0]
    assert win.seconds == 3.0
    assert walker_sweeps_per_s(win, 8) == 4 * 8 / 3.0


def test_p90_is_the_exclusive_90th_percentile_of_every_sweep():
    d = [0.30 + 0.001 * i for i in range(120)] + [0.9, 1.1]
    assert p90(d) == statistics.quantiles(d, n=10)[-1]
    # more than ten samples lie beyond it when there are more than 100 sweeps
    assert sum(v > p90(d) for v in d) > 10
