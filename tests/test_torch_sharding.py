"""The port's sharded steps against the reference's own sharded steps.

The port runs as 4 gloo processes on the CPU, a 2 x 2 (data, model) mesh
(`tests/torch_sharding_worker.py`); the reference runs in a jax process
with 4 forced host devices and a 2 x 2 mesh of `Auto` axes
(`tests/jax_sharding_ref.py`), on the same seeded float32 weights and
global batch. Cases: qwen2-72b SMOKE (4 heads: head tensor parallelism,
and with accum=2), qwen2-1.5b SMOKE in weightgather mode and yi-34b SMOKE
(7 heads) (both sequence-sharded attention), mixtral-8x7b SMOKE at
4 x 2,048 = 8,192 tokens (the shard_map MoE path with per-shard capacity
and the contiguous `model` blocks of [gate | up]), and, each with a
prefill and two decode steps, mixtral-8x7b SMOKE at 4 x 32 tokens (the
short MoE path, its expert products split over d and F), zamba2-7b and
xlstm-1.3b SMOKE (the Mamba2, mLSTM and sLSTM blocks split over
`model`). The qwen2-1.5b and yi-34b cases serve with
`param_shardings(serve=True)`, and so does the short MoE case (its
expert weights' d then comes whole and each process cuts its block), the
others with the training specs. The reference runs the last three cases
in a second jax process beside the first.

Tolerances: `loss_fn(ctx)`, the step's loss and gradient norm 1e-5
relative; the updated parameters 1e-4 of a leaf's largest magnitude where
the reference's gradient is at least 1e-6, 2 lr elsewhere (AdamW's first
step, `tests/test_torch_train.py`); prefill and decode logits on an
S-sharded cache 1e-4 of their largest magnitude; greedy tokens equal.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_sharding_worker as tw

LR = 1e-2
CASES = [
    dict(name="qwen2-72b_head_tp", arch="qwen2-72b", B=4, L=32, gen=4),
    dict(name="qwen2-72b_accum2", arch="qwen2-72b", B=4, L=32, accum=2),
    dict(name="qwen2-1.5b_weightgather", arch="qwen2-1.5b",
         sp_mode="weightgather", B=4, L=32, gen=4, serve=True),
    dict(name="yi-34b_seq_sharded", arch="yi-34b", B=4, L=32, gen=4,
         serve=True),
    dict(name="mixtral_sharded_moe", arch="mixtral-8x7b", B=4, L=2048,
         local_control=True),
    dict(name="mixtral_short_moe", arch="mixtral-8x7b", B=4, L=32, gen=2,
         serve=True, second=True),
    dict(name="zamba2_partitioned", arch="zamba2-7b", B=4, L=32, gen=2,
         second=True),
    dict(name="xlstm_partitioned", arch="xlstm-1.3b", B=4, L=32, gen=2,
         second=True),
]
NAMES = [c["name"] for c in CASES]
GEN = [c["name"] for c in CASES if c.get("gen")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sharded"))
    cases = [tw.write_inputs(dict(c, lr=LR), d) for c in CASES]
    port = tw.launch(cases, d)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(tw.ROOT, "src"))
    refs = []
    for part in (False, True):
        path = os.path.join(d, f"ref_cases_{int(part)}.json")
        with open(path, "w") as f:
            json.dump([c for c in cases if c.get("second", False) == part],
                      f)
        refs.append(subprocess.Popen(
            [sys.executable,
             os.path.join(tw.ROOT, "tests", "jax_sharding_ref.py"), path, d],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        out, _ = port.communicate(timeout=600)
        errs = [r.communicate(timeout=600)[1] for r in refs]
    finally:
        for p in [port] + refs:
            if p.poll() is None:
                p.kill()
    assert port.returncode == 0, out[-4000:]
    for r, err in zip(refs, errs):
        assert r.returncode == 0, err[-4000:]
    return {c["name"]: (np.load(os.path.join(d, c["name"] + ".npz")),
                        np.load(os.path.join(d, c["name"] + "_ref.npz")))
            for c in CASES}


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("name", NAMES)
def test_sharded_loss_matches_the_reference_sharded_loss(runs, name):
    got, ref = runs[name]
    assert rel(got["loss_fn"], ref["loss_fn"]) < 1e-5
    assert rel(got["loss"], ref["loss"]) < 1e-5


def step_misses(got, ref, prefix=""):
    """The limits a train step's output `got` misses against the
    reference's sharded step `ref` (an empty list: it meets them all):
    loss and gradient norm 1e-5 relative, the parameters 1e-4 of a leaf's
    largest magnitude where the reference's gradient is at least 1e-6,
    2 lr elsewhere. `prefix` picks `got`'s keys."""
    out = []
    for key in ("loss", "grad_norm"):
        if not rel(got[prefix + key], ref[key]) < 1e-5:
            out.append(key)
    for k in (k for k in ref.files if k.startswith("param/")):
        a, b = got[prefix + k], ref[k]
        g = ref["grad/" + k[len("param/"):]]
        big = np.abs(g) >= 1e-6
        scale = np.abs(b).max()
        if not (np.abs(a - b)[big].max(initial=0) <= 1e-4 * scale
                and np.abs(a - b)[~big].max(initial=0) <= 2 * LR):
            out.append(k)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_sharded_train_step_matches_the_reference_sharded_step(runs, name):
    got, ref = runs[name]
    params = [k for k in ref.files if k.startswith("param/")]
    assert params and sorted(params) == sorted(
        k for k in got.files if k.startswith("param/"))
    assert step_misses(got, ref) == []


@pytest.mark.parametrize("name", GEN)
def test_sharded_prefill_and_decode_match_the_reference(runs, name):
    got, ref = runs[name]
    for key in ("prefill_logits", "decode_logits"):
        scale = np.abs(ref[key]).max()
        assert np.abs(got[key] - ref[key]).max() <= 1e-4 * scale, key
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])


def test_sharded_moe_per_shard_capacity_is_not_the_local_path(runs):
    """At 8,192 tokens the sharded MoE path runs, with each data shard's
    own capacity: the port's step meets the limits against the
    reference's sharded step, and the reference's local path (one
    dispatch over all the tokens, `ctx=None`) on the same inputs misses
    at least one of them, so the case tells the two paths apart."""
    got, ref = runs["mixtral_sharded_moe"]
    assert int(got["collective_calls"]) > 0
    assert step_misses(got, ref) == []
    assert step_misses(ref, ref, prefix="local/") != []
