"""A run with the timed path broken underneath comes out not correct,
once for each fault the cell can have; a sound run comes out correct.
The look for a card is skipped: the run drives the CPU path."""
import dataclasses

import pytest
import torch

import repro_torch.api.simulator as simulator
import repro_torch.core.dram as dram
from simbench.harness import cell as cm, registry

from ._small import small_cell


def _run(name, trace=False):
    return cm.run(small_cell(name), seed=12345, seconds=1e-3, trace=trace,
                  device="cpu")


def _replay_unchanged(orig):
    """The replay returns its state unchanged: no stall accrues."""
    def fn(*a, **k):
        res = orig(*a, **k)
        return dataclasses.replace(
            res, stall_cycles=torch.zeros_like(res.stall_cycles))
    return fn


def _half_the_batch(orig):
    """Half the designs left out, the mean of the rest in their place."""
    def fn(*a, **k):
        out = orig(*a, **k)
        n = next(iter(out.values())).shape[0]
        h = max(1, n // 2)
        return {c: torch.cat([v[:h], v[:h].mean(0, keepdim=True)
                              .expand(n - h, *v.shape[1:])])
                for c, v in out.items()}
    return fn


def _one_answer_altered(orig):
    """One design's energy altered where it is produced."""
    def fn(*a, **k):
        out = dict(orig(*a, **k))
        e = out["energy_pj"].clone()
        e[0] = e[0] * 1.001
        out["energy_pj"] = e
        return out
    return fn


def _replay_raises(orig):
    def fn(*a, **k):
        raise RuntimeError("replay lost")
    return fn


FAULTS = [(dram, "replay_requests", _replay_unchanged),
          (simulator, "_design_metrics", _half_the_batch),
          (simulator, "_design_metrics", _one_answer_altered),
          (dram, "replay_requests", _replay_raises)]


@pytest.mark.parametrize(
    "name", [w["name"] for w in registry.load_benchmark()["workloads"]])
def test_a_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == 6
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("mod,attr,fault", FAULTS,
                         ids=[f[2].__name__ for f in FAULTS])
def test_a_broken_path_is_not_correct(monkeypatch, mod, attr, fault):
    monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))
    res = _run("resnet18.trace64k")
    assert not res["correct"]
    assert res["failed"] >= 1


def test_a_traced_run_reads_its_layers():
    res = _run("vit_base.trace64k", trace=True)
    assert res["correct"]
    m = res["metrics"]
    assert {"plan_frame_ms", "stage_math_ms", "streams_ms", "replay_ms",
            "requests_per_pass", "replay_roofline", "sweep_mfu"} <= set(m)
    # no device trace on the CPU: the device's idle share is left out
    assert "device_idle_share" not in m
    assert 0 < m["replay_roofline"]["value"] < 100
    assert 0 < m["sweep_mfu"]["value"] < 100
    # spans are taken off again
    assert dram.replay_requests.__qualname__ == "replay_requests"
