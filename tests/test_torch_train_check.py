"""Phase 39's train check of `chip_smoke.py` (`train_check`,
`one_device_train`) on the CPU: a world's losses and gradient norms are
held step by step within the larger of `TRAIN_F32_TOL` and twice one
device's envelope (the largest gap of its nudged runs at that step); a
world outside it at either step, or a non-finite value, fails the run (a
non-zero `SystemExit` through `chip_smoke.fail`) after the comparison is
printed; and mixtral-8x7b's SMOKE config trained in float32 on a 2 x 2
gloo world through `run_world` (phase 39's own path) passes against one
CPU device."""
import dataclasses
import json
import math
import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the script at the repo's root)
from repro_torch.configs import get_config  # noqa: E402

# one device's reference: step 1's envelope under the floor, step 2's over
ONE = dict(dtype="float32", losses=[10.0, 9.0], grad_norms=[50.0, 40.0],
           envelope=dict(losses=[1e-6, 1e-3], grad_norms=[2e-6, 4e-3]),
           seconds=1.0)
# and the bounds that follow: max(TRAIN_F32_TOL, 2 x envelope)
BOUNDS = dict(loss=[1e-4, 2e-3], grad_norm=[1e-4, 8e-3])


def world(losses=(1 + 9e-5, 1 - 1.9e-3), norms=(1 - 9e-5, 1 + 7.9e-3)):
    """A world's rank-0 numbers, each one device's times a factor."""
    return dict(losses=[o * f for o, f in zip(ONE["losses"], losses)],
                grad_norms=[o * f for o, f in zip(ONE["grad_norms"], norms)])


def test_train_check_passes_inside_the_envelope(capsys):
    out = chip_smoke.train_check(world(), ONE)
    assert out["ok"] and out["dtype"] == "float32"
    assert out["one_card_seconds"] == ONE["seconds"]
    assert [r["step"] for r in out["steps"]] == [1, 2]
    for s, row in enumerate(out["steps"]):
        for name in ("loss", "grad_norm"):
            r = row[name]
            assert r["ok"] and r["bound"] == pytest.approx(BOUNDS[name][s])
            assert r["gap"] == pytest.approx(
                abs(r["world"] - r["one_card"]) / r["one_card"])
            assert r["gap"] <= r["bound"]
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("phase four_cards_mixtral_train: ")


@pytest.mark.parametrize("kw,where", [
    (dict(norms=(1 - 9e-5, 1 + 8.5e-3)), "step 2 grad_norm"),
    (dict(losses=(1 + 2e-4, 1 - 1.9e-3)), "step 1 loss"),
    (dict(losses=(math.nan, 1 - 1.9e-3)), "step 1 loss"),
], ids=["step_2_only", "step_1_only", "non_finite_loss"])
def test_train_check_fails_outside_the_envelope(kw, where, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.train_check(world(**kw), ONE)
    msg = str(exc.value)
    assert msg.startswith("chip_smoke FAIL: four_cards_mixtral train")
    assert where in msg and msg.count("step ") == 1
    # the comparison reached the output before the failure
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line.split(": ", 1)[1])
    assert out["ok"] is False
    assert [r[n]["ok"] for r in out["steps"] for n in ("loss", "grad_norm")
            ].count(False) == 1


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_smoke_world_passes_against_one_device(one_thread):
    cfg = dataclasses.replace(get_config(chip_smoke.MIX_ARCH, smoke=True),
                              param_dtype="float32")
    B, L = 4, 32
    one = chip_smoke.one_device_train(cfg, torch.device("cpu"), B=B, L=L)
    assert len(one["nudged"]) == chip_smoke.TRAIN_NUDGES
    assert all(len(v) == chip_smoke.TRAIN_STEPS
               for v in one["envelope"].values())
    job = dict(name="mixtral_train", arch=chip_smoke.MIX_ARCH, smoke=True,
               param_dtype="float32", seed=0, B=B, L=L,
               steps=chip_smoke.TRAIN_STEPS)
    w = chip_smoke.run_world(
        "test_train_check", dict(backend="gloo", device="cpu", mesh=[2, 2],
                                 jobs=[job], threads=1),
        nprocs=4, timeout=120)
    ranks, _ = w["mixtral_train"]
    assert [r["mesh"] for r in ranks] == [{"data": 2, "model": 2}] * 4
    out = chip_smoke.train_check(ranks[0], one)
    assert out["ok"] and len(out["steps"]) == chip_smoke.TRAIN_STEPS
