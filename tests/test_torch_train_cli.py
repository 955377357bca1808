"""The port's training launcher (`python -m repro_torch.launch.train`) as a
subprocess on the CPU: a plain run, `--compress-pod-grads`, a run with
checkpoints every 3 steps resumed from its step-6 checkpoint (the resumed
steps' losses equal to the uninterrupted run's), the `--sim-accel`
line equal to the reference's modeled train step, no `jax` and no
`repro` loaded, and no quiet fall-back to the CPU without a card."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

import repro.api as rapi
from repro.configs import get_config as rget
from repro_torch.launch import train as ttrain

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir,
                                   "src"))
SMOKE = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--batch",
         "2", "--seq", "32"]


def _run(args):
    # one intra-op thread: the suite runs several workers on the same cores
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], env=env,
                          capture_output=True, text=True, timeout=300)


def _train(*args):
    proc = _run(["-m", "repro_torch.launch.train", *SMOKE, *args])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout.splitlines()


def test_train_cli_runs_with_the_modeled_step(tmp_path):
    lines = _train("--steps", "6", "--ckpt-every", "0", "--ckpt-dir",
                   str(tmp_path), "--sim-accel", "paper-32", "--tp", "4")
    sim = rapi.Simulator("paper-32")
    rep = sim.run_lm(rget("qwen2-1.5b"), seq=32, batch=2, mode="train")
    assert lines[0] == (
        f"[sim:paper-32] modeled train step: "
        f"{sim.seconds(rep.total_cycles) * 1e3:.2f} ms, "
        f"{rep.energy_pj * 1e-9:.1f} mJ, util={rep.utilization:.2f}")
    assert [ln.split(":")[0] for ln in lines[1:3]] == ["step 0", "step 5"]
    assert lines[-1].startswith("done. loss ")
    assert os.listdir(tmp_path) == ["step_00000006"]


def test_train_cli_compresses_the_gradients(tmp_path):
    plain = _train("--steps", "2", "--ckpt-every", "0", "--ckpt-dir",
                   str(tmp_path / "a"), "--log-every", "1")
    comp = _train("--steps", "2", "--ckpt-every", "0", "--ckpt-dir",
                  str(tmp_path / "b"), "--log-every", "1",
                  "--compress-pod-grads")
    assert comp[-1].startswith("done. ")
    # the same first loss (same weights and batch); int8 gradients move
    # the second
    assert comp[0].split()[2] == plain[0].split()[2]
    assert comp[1].split()[2] != plain[1].split()[2]


def test_train_cli_resumes_from_a_checkpoint(tmp_path):
    ck = str(tmp_path)
    full = _train("--steps", "8", "--ckpt-every", "3", "--ckpt-dir", ck,
                  "--log-every", "1")
    assert sorted(os.listdir(ck)) == ["step_00000006", "step_00000008"]
    shutil.rmtree(os.path.join(ck, "step_00000008"))
    resumed = _train("--steps", "8", "--ckpt-every", "3", "--ckpt-dir", ck,
                     "--log-every", "1", "--resume")
    assert resumed[0] == "resumed from step 6"
    loss = lambda ln: ln.split()[2]          # "loss=..." (not the time)
    assert [loss(ln) for ln in resumed[1:3]] == [loss(ln) for ln in full[6:8]]
    assert resumed[-1].startswith("done. ")


def test_train_cli_imports_neither_jax_nor_the_reference(tmp_path):
    code = (
        "import sys\n"
        "from repro_torch.launch import train\n"
        f"assert train.main({SMOKE + ['--steps', '2', '--ckpt-dir', str(tmp_path), '--compress-pod-grads', '--sim-accel', 'paper-32']!r}) == 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print('LEAKED', bad)\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout and "done. " in proc.stdout


def test_train_defaults_to_cuda_and_never_falls_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default would use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
