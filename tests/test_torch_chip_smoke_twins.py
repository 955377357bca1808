"""The CPU twins of `chip_smoke.py` (`TwinPool`, `submit_study`,
`join_frame`), on the CPU: the card phases hold their results against
CPU runs made in background processes. A study's frame put together from
its twin jobs equals the same study run inline, bit for bit; a twin
process sees no CUDA device and keeps to its cores and threads; and a
twin that raises, runs past its time limit or dies fails the run (a
non-zero `SystemExit` through `chip_smoke.fail`) and leaves no process of
the pool alive."""
import operator
import os
import pathlib
import sys
import time

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the script at the repo's root)

CORES = sorted(os.sched_getaffinity(0))


def test_twin_frame_equals_inline_run():
    study = chip_smoke.cycle_study()        # fast, cycle (per-op) and trace
    with chip_smoke.TwinPool(CORES, 2, 1) as pool:
        chip_smoke.submit_study(pool, "cycle_study", chip_smoke.cycle_study)
        inline = study.run(device="cpu")
        frame, info = chip_smoke.join_frame(pool, "cycle_study", study)
    plan = study.plan()
    assert sorted(info["cpu_job_s"]) == sorted(
        [f"group{i}" for i in range(len(plan.groups))] + ["per_op"])
    assert info["cpu_run_s"] > 0 and info["cpu_wait_s"] >= 0
    assert len(frame) == 6 and frame.equals(inline)
    assert frame.meta == inline.meta == {"engine": "torch:plain",
                                         "device": "cpu"}
    assert not any(p.is_alive() for p in pool.procs)


def test_twin_process_sees_no_card_and_keeps_its_cores():
    cores = CORES[-1:]
    with chip_smoke.TwinPool(cores, 1, 1) as pool:
        pool.submit("visible", os.getenv, "CUDA_VISIBLE_DEVICES")
        pool.submit("affinity", os.sched_getaffinity, 0)
        pool.submit("threads", torch.get_num_threads)
        assert pool.join("visible")[0] == ""
        assert pool.join("affinity")[0] == set(cores)
        assert pool.join("threads")[0] == 1


@pytest.mark.parametrize("fn,args,limit_s", [
    (operator.truediv, (1, 0), 60.0),
    (time.sleep, (60,), 2.0),
    (os._exit, (3,), 60.0),
], ids=["raises", "past_its_limit", "dies"])
def test_failing_twin_fails_the_run(fn, args, limit_s):
    pool = chip_smoke.TwinPool(CORES[-1:], 1, 1, limit_s=limit_s)
    pool.submit("bad", fn, *args)
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as exc:
        pool.join("bad")
    assert str(exc.value.code).startswith("chip_smoke FAIL: twin bad")
    assert time.perf_counter() - t0 < 30
    assert not any(p.is_alive() for p in pool.procs)
