"""The examples' twins (`examples/torch_*.py`) on the CPU, in this process
on one intra-op thread: their printed lines against the reference
examples' (`examples/*.py`) where the two compute the same thing."""
import os
import runpy
import sys
import tempfile

import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_example(name, args, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name, *args])
    runpy.run_path(os.path.join(ROOT, "examples", name),
                   run_name="__main__")
    return capsys.readouterr().out.splitlines()


def test_quickstart_prints_the_reference_s_lines(capsys, monkeypatch,
                                                 tmp_path):
    from repro.core.engine import NetworkReport
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    got = run_example("torch_quickstart.py", ["--device", "cpu"], capsys,
                      monkeypatch)
    # the reference writes its CSV to /tmp: keep it inside the test's dir
    written = []
    monkeypatch.setattr(NetworkReport, "write_csv",
                        lambda self, path: written.append(path))
    ref = run_example("quickstart.py", [], capsys, monkeypatch)
    assert written == ["/tmp/quickstart_report.csv"]
    csv = os.path.join(str(tmp_path), "quickstart_report.csv")
    assert got[-1] == f"per-layer report -> {csv}" and os.path.exists(csv)
    assert got[:-1] == ref[:-1]


def test_dse_sweep_prints_the_reference_s_lines(capsys, monkeypatch):
    args = ["--arch", "whisper-base", "--seq", "64", "--sram-mb", "0.5",
            "8.0"]
    got = run_example("torch_dse_sweep.py", args + ["--device", "cpu"],
                      capsys, monkeypatch)
    sharded = run_example("torch_dse_sweep.py",
                          args + ["--device", "cpu", "--shard"], capsys,
                          monkeypatch)
    ref = run_example("dse_sweep.py", args, capsys, monkeypatch)
    assert got == sharded
    # the summary's header names the package and device; the rows, the
    # winners and the Pareto front are the reference's
    assert got[0] == ref[0]
    assert got[-10:] == ref[-10:]


def test_serve_batch_serves_and_co_simulates(capsys, monkeypatch):
    import repro.api as rapi
    from repro.configs import get_config as rget
    out = run_example("torch_serve_batch.py",
                      ["--device", "cpu", "--gen-len", "4", "--seed", "3"],
                      capsys, monkeypatch)
    assert out[0].startswith("served 4 seqs x 4 tokens in ")
    assert out[0].endswith("tok/s on CPU)")
    assert len(eval(out[1].split("sample: ")[1])) == 4
    # the co-simulated wave is the reference's
    sim = rapi.Simulator.from_preset("tpu-like", array=128)
    rp = sim.run_lm(rget("qwen2-1.5b"), seq=32, batch=4, mode="prefill")
    rd = sim.run_lm(rget("qwen2-1.5b"), seq=32, batch=4, mode="decode",
                    cache_len=36)
    cyc, _ = sim.wave_cost(rp, rd, 4)
    assert out[-2] == (f"  prefill {rp.total_cycles:.3e} cyc; decode "
                       f"{rd.total_cycles:.3e} cyc/step")
    assert out[-1].startswith(f"  wave total: {cyc / 1e6:.1f} Mcycles")


def test_train_lm_loss_decreases_and_checkpoints(capsys, monkeypatch,
                                                 tmp_path):
    ck = str(tmp_path / "ck")
    out = run_example("torch_train_lm.py",
                      ["--device", "cpu", "--steps", "20", "--batch", "2",
                       "--seq", "32", "--ckpt-dir", ck], capsys,
                      monkeypatch)
    assert out[0] == "model: qwen2-20m (8.9M params), 20 steps of 2x32"
    assert out[-1].startswith("loss: ") and "reduction" in out[-1]
    first, last = (float(v) for v in
                   out[-1].split("loss: ")[1].split(" (")[0].split(" -> "))
    assert last < first
    assert os.listdir(ck)
