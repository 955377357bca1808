"""The runs of `tests/test_torch_zoo.py` in bfloat16, the served dtype:
all 10 SMOKE architectures on the reference's own weights, prefill,
decode from the reference's prefill cache and from a zero cache, and the
loss, within 3e-2 of the reference's largest magnitude (logits, every
cache leaf, the loss). Greedy tokens are not held equal: the two
frameworks round bfloat16 at other places, which can swap near ties."""
import numpy as np
import pytest
import torch

from repro.configs import list_archs
from repro_torch.models.decode import cache_from_reference
from test_torch_zoo import (B, L, LOSS_KEYS, PREFILL_KEYS, check_tree,
                            port_model, reference_run, rel, tbatch)

ARCHS = list_archs()
BF16_TOL = 3e-2


@pytest.fixture(scope="module")
def runs():
    memo = {}

    def get(arch):
        if arch not in memo:
            memo[arch] = reference_run(arch, "bfloat16")
        return memo[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_match_reference(runs, arch):
    ref = runs(arch)
    bundle, model = port_model(arch, "bfloat16", ref)
    assert model.embed.dtype == torch.bfloat16
    with torch.inference_mode():
        logits, cache = bundle.prefill(
            model, tbatch(ref["x"], "bfloat16", PREFILL_KEYS))
        assert rel(logits, ref["logits"]) < BF16_TOL
        check_tree(cache, ref["cache"], BF16_TOL)
        cache = cache_from_reference(bundle.cfg, ref["cache"],
                                     device="cpu")
        tok = torch.from_numpy(np.asarray(ref["logits"]).argmax(-1))[:, None]
        logits, cache = bundle.decode(model, cache, tok, L)
        assert rel(logits, ref["d_logits"]) < BF16_TOL
        check_tree(cache, ref["d_cache"], BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_zero_cache_decode_and_loss_match_reference(runs, arch):
    ref = runs(arch)
    bundle, model = port_model(arch, "bfloat16", ref)
    with torch.inference_mode():
        cache = bundle.init_cache(batch=B, cache_len=L, device="cpu")
        logits, cache = bundle.decode(
            model, cache, torch.from_numpy(ref["x"]["token"]), 5)
        assert rel(logits, ref["z_logits"]) < BF16_TOL
        check_tree(cache, ref["z_cache"], BF16_TOL)
        loss = bundle.loss(model, tbatch(ref["x"], "bfloat16", LOSS_KEYS))
    assert abs(float(loss) - ref["loss"]) <= BF16_TOL * abs(ref["loss"])
