"""The design samples a run draws from its seed."""
import collections

import pytest

from simbench.harness import designs as dz
from simbench.harness.registry import load_mix

MIX = load_mix("trace64k")


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 3 * 2**31 + 5])
def test_samples_repeat_from_a_seed(seed):
    assert dz.samples(MIX, seed) == dz.samples(MIX, seed)


def test_seeds_change_the_grouping_not_the_work():
    a, b = dz.samples(MIX, 1), dz.samples(MIX, 2)
    assert a != b
    for s in (a, b):
        count = collections.Counter(dz.label(d) for x in s for d in x)
        assert len(count) == len(dz.grid(MIX)) == 90
        assert set(count.values()) == {MIX["samples"] - 1}


@pytest.mark.parametrize("seed", [3, 4_000_000_001])
def test_every_sample_has_the_same_strata(seed):
    for s in dz.samples(MIX, seed):
        assert len(s) == MIX["designs_per_pass"] == 72
        assert len({dz.label(d) for d in s}) == 72
        by = collections.Counter(d["dataflow"] for d in s)
        assert by == {"ws": 24, "os": 24, "is": 24}


def test_a_grid_that_does_not_split_is_refused():
    mix = dict(MIX, samples=4)
    with pytest.raises(ValueError):
        dz.samples(mix, 0)
