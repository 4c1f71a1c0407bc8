"""ZeRO-1 (``shard_opt_state: true``) in the port, the counterpart of
tests/test_zero1.py, on two gloo ranks (tests/torch_dp_worker.py's
``layouts`` job) against the JAX step (tests/torch_layouts.py).

The AdamW moments shard over the data axis, parameters and gradients stay
replicated, and AdamW is elementwise: the trajectory is the replicated
port step's **bit for bit** (losses, and a sha256 of the full parameters
and running statistics), on ``tp-tiny`` and on ``rn-tiny``.  Each rank
keeps at most 0.6× of the replicated moments' bytes (about half).  A
full-state save at step 2 and a resume into a fresh sharded state repeat
step 3 bit for bit.  The same launch runs the gathered GradCache layout
(``allow_accum_gather`` with a microbatch of 1 row, which 2 ranks do not
divide): every rank gathers the global batch, takes the JAX dp = 1
microbatches, and sums nothing twice; it is held against the JAX step
with the same microbatches on one device.  Losses rel 1e-4 and held-out
embeddings rtol 2e-3, atol 5e-5 against JAX (the JAX test's tolerances).
"""

import pytest

from sparsify_clip_tpu_torch.config import ExperimentConfig
from sparsify_clip_tpu_torch.parallel.mesh import Mesh
from sparsify_clip_tpu_torch.train import TrainStep

import torch_layouts as tl

WORLD = 2
CASES = {
    "dp2": dict(model="tp-tiny"),
    "dp2-zero1": dict(model="tp-tiny", shard_opt_state=True, save_at=2),
    "rn-dp2": dict(model="rn-tiny"),
    "rn-dp2-zero1": dict(model="rn-tiny", shard_opt_state=True),
    "dp2-gather": dict(model="tp-tiny", ref="tp-tiny-accum", grad_accum_steps=tl.B,
                       allow_accum_gather=True),
}
ACCUM = dict(grad_accum_steps=tl.B)  # the JAX dp = 1 microbatches, the gathered layout's
REFS = {"tp-tiny": ("tp-tiny", {}), "rn-tiny": ("rn-tiny", {}),
        "tp-tiny-accum": ("tp-tiny", ACCUM)}
PAIRS = {"vit": ("dp2", "dp2-zero1"), "rn": ("rn-dp2", "rn-dp2-zero1")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    got = tl.layouts(tmp_path_factory, "zero1", {WORLD: CASES}, REFS)
    return dict(refs=got["refs"], run=got["worlds"][WORLD])


@pytest.mark.parametrize("case", sorted(CASES))
def test_layouts_match_the_jax_step(runs, case):
    spec = CASES[case]
    tl.assert_matches_jax(runs["run"], case, runs["refs"][spec.get("ref", spec["model"])])


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_zero1_is_bit_identical_to_the_replicated_step(runs, pair):
    plain, zero1 = (runs["run"]["results"][0][c] for c in PAIRS[pair])
    assert zero1["log"] == plain["log"]
    assert zero1["digest"] == plain["digest"]


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_zero1_shards_the_moments_alone(runs, pair):
    for rank in runs["run"]["results"]:
        plain, zero1 = (rank[c]["bytes"] for c in PAIRS[pair])
        assert zero1["params"] == plain["params"]
        assert zero1["moments"] <= 0.6 * plain["moments"], (zero1, plain)


def test_zero1_resume_repeats_step_3_bit_for_bit(runs):
    tl.assert_resumes_bit_for_bit(runs["run"], "dp2-zero1", 2)


def test_gathered_layout_warns_as_jax_does():
    config = ExperimentConfig.from_dict(dict(tl.EXP6, model="tp-tiny", grad_accum_steps=tl.B,
                                             allow_accum_gather=True))
    with pytest.warns(UserWarning, match="microbatch 1, not divisible by the data-mesh size 2"):
        step = TrainStep(config, tl.SPE, 2 * tl.SPE, lambda s: 1e-3, mesh=Mesh(data=2))
    assert step.gathered and step.step_mesh.data == 1
