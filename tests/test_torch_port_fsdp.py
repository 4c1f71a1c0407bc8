"""FSDP (``fsdp: true``) in the port, the counterpart of tests/test_fsdp.py,
on two gloo ranks (tests/torch_dp_worker.py's ``layouts`` job) against the
JAX step (tests/torch_layouts.py).

Parameters and AdamW moments shard over the data axis; each residual
block and each tower's remaining weights gather before their forward, and
their gradients reduce-scatter.  Held against JAX on ``tp-tiny`` and
``rn-tiny`` (global BatchNorm), one shot, with GradCache at 2
microbatches (the JAX test's composition, tests/test_fsdp.py:189) and
under ``remat`` (the recompute gathers each block again): losses
rel 1e-4, held-out embeddings rtol 2e-3, atol 5e-5 (the JAX test's
tolerances).  Each rank holds at most 0.6× the bytes of the replicated
parameters and moments.  A full-state save at step 2 and a resume into a
fresh sharded state repeat step 3 bit for bit, and the weights file holds
the JAX keys at full shape.
"""

import numpy as np
import pytest

import torch_layouts as tl

WORLD = 2
REFS = {"tp-tiny": ("tp-tiny", {}), "rn-tiny": ("rn-tiny", {})}
CASES = {
    "dp2-fsdp": dict(model="tp-tiny", fsdp=True, save_at=2, npz=True),
    "rn-dp2-fsdp": dict(model="rn-tiny", fsdp=True),
    "dp2-fsdp-gradcache": dict(model="tp-tiny", fsdp=True, grad_accum_steps=2),
    # the recompute calls each block again, which gathers its weights again
    "dp2-fsdp-remat": dict(model="tp-tiny", fsdp=True, remat=True),
    "rn-dp2-fsdp-remat": dict(model="rn-tiny", fsdp=True, remat=True),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    got = tl.layouts(tmp_path_factory, "fsdp", {WORLD: CASES}, REFS)
    return dict(refs=got["refs"], run=got["worlds"][WORLD])


@pytest.mark.parametrize("case", sorted(CASES))
def test_fsdp_matches_the_jax_step(runs, case):
    tl.assert_matches_jax(runs["run"], case, runs["refs"][CASES[case]["model"]])


@pytest.mark.parametrize("case", sorted(CASES))
def test_fsdp_shards_parameters_and_moments(runs, case):
    final = runs["refs"][CASES[case]["model"]]["final"]
    replicated = 3 * 4 * sum(v.size for v in final.values())  # fp32 params, mu, nu
    for rank in runs["run"]["results"]:
        held = rank[case]["bytes"]
        assert held["params"] + held["moments"] <= 0.6 * replicated, (held, replicated)


def test_fsdp_resume_repeats_step_3_bit_for_bit(runs):
    tl.assert_resumes_bit_for_bit(runs["run"], "dp2-fsdp", 2)


def test_fsdp_weights_file_holds_the_jax_keys_at_full_shape(runs):
    rank0 = runs["run"]["results"][0]["dp2-fsdp"]
    tl.assert_weights_file(rank0["npz"], runs["refs"]["tp-tiny"])
    with np.load(rank0["npz"]) as f:  # and the trained values
        for key, want in runs["refs"]["tp-tiny"]["final"].items():
            assert np.abs(f[key] - want).max() <= 3e-3, key
