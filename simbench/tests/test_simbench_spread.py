"""The readings the bounds are set from: the quartile spread as a share
of the median, the widest over the sets, and five times it."""
import statistics

import pytest

from simbench import spread


def _set(values):
    return [dict(metrics=dict(designs_per_s=v)) for v in values]


def test_the_spread_is_the_quartiles_over_the_median():
    vals = [100.0, 101.0, 99.0, 103.0, 98.0, 100.0]
    q1, _, q3 = statistics.quantiles(vals, n=4)
    assert spread.spread(vals) == pytest.approx((q3 - q1) / 100.0)


@pytest.mark.parametrize("a,b,bound", [
    ([100, 101, 99, 103, 98, 100], [100] * 6, 0.14),
    ([100.0] * 6, [100.0] * 6, 0.01),
    ([1000, 1010, 990, 1030, 980, 1000], [1000, 1100, 900, 1000, 1050,
                                          950], 0.63),
])
def test_the_bound_is_five_times_the_widest_spread(a, b, bound):
    s = spread.summarise([_set(a), _set(b)])["designs_per_s"]
    assert s["widest"] == max(spread.spread(a), spread.spread(b))
    assert s["rule_bound"] == bound
    assert [p["n"] for p in s["sets"]] == [6, 6]


def test_the_trimmed_spread_leaves_out_the_farthest_run():
    a = [100.0, 101.0, 99.0, 103.0, 98.0, 130.0]
    b = [100.0, 100.0, 101.0, 99.0, 100.0, 100.0]
    s = spread.summarise([_set(a), _set(b)])["designs_per_s"]
    assert spread.trimmed(a) == spread.spread(a[:5])
    assert s["trimmed"] == pytest.approx(
        (spread.spread(a[:5]) + spread.trimmed(b)) / 2)
    assert s["trimmed"] < s["widest"]


def test_a_failed_run_is_left_out():
    rows = _set([100, 101, 99, 103, 98]) + [dict(rc=1)]
    s = spread.summarise([rows])["designs_per_s"]
    assert s["sets"][0]["n"] == 5
