"""Tensor parallelism (``mesh_model > 1``) in the port, the counterpart of
tests/test_tp_equivalence.py, on gloo ranks (tests/torch_dp_worker.py's
``layouts`` job) against the JAX step (tests/torch_layouts.py).

One launch of 2 ranks runs dp 1 × tp 2 on ``tp-tiny`` (non-4× MLP widths
48 and 24), on ``rn-tiny`` (the attention pool's ``c_proj`` row-parallel)
and with ``fused_ln_qkv`` (the fused kernel's plain version over the local
3W/tp columns); one launch of 4 ranks runs dp 2 × tp 2 alone, under ZeRO-1
and under FSDP.  The launches also run the pipeline's cases
(tests/test_torch_port_pipeline.py, ``torch_layouts.model_axis_layouts``).
Losses rel 1e-4 and held-out embeddings rtol 2e-3, atol 5e-5 against JAX
(the JAX test's tolerances); every rank holds the same full state.  A
full-state save at step 2 and a resume into a fresh state of the same
layout repeat step 3 bit for bit, and the weights file holds the JAX keys
at full shape.

Without a launch: the head-aligned split of every split weight, then the
join, returns the JAX arrays bit for bit, and each rank's in_proj rows are
the q, k and v rows of its heads; the attention route under tensor
parallelism is the one-process route at ViT-L-14-336's shape, where the
local width alone would take the other route.
"""

import numpy as np
import pytest
import torch

from sparsify_clip_tpu_torch.checkpoints import torch_name
from sparsify_clip_tpu_torch.ops import attention
from sparsify_clip_tpu_torch.parallel import tensor

import torch_layouts as tl

CASES = tl.TP_CASES
ALL = {name: (world, spec) for world, cases in CASES.items() for name, spec in cases.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # the launches hold the pipeline's cases too (tests/test_torch_port_pipeline.py)
    return tl.model_axis_layouts(tmp_path_factory)


@pytest.mark.parametrize("case", sorted(ALL))
def test_tp_matches_the_jax_step(runs, case):
    world, spec = ALL[case]
    run = runs["worlds"][world]
    assert run["results"][0][case]["mesh"] == [world // 2, 2]
    tl.assert_matches_jax(run, case, runs["refs"][spec["model"]])


@pytest.mark.parametrize("case", ["tp2", "dp2tp2-fsdp"])
def test_tp_resume_repeats_step_3_bit_for_bit(runs, case):
    tl.assert_resumes_bit_for_bit(runs["worlds"][ALL[case][0]], case, 2)


def test_tp_weights_file_holds_the_jax_keys_at_full_shape(runs):
    tl.assert_weights_file(runs["worlds"][2]["results"][0]["tp2"]["npz"], runs["refs"]["tp-tiny"])


@pytest.mark.parametrize("model", ["tp-tiny", "rn-tiny"])
@pytest.mark.parametrize("tp", [2, 4])
def test_split_then_join_returns_the_jax_arrays(runs, model, tp):
    from sparsify_clip_tpu_torch.checkpoints import _dense_inv

    with np.load(runs["refs"][model]["initial"]) as f:
        flat = {k: f[k] for k in f.files if not k.startswith("batch_stats/")}
    split_any = 0
    for path, arr in flat.items():
        name = torch_name(path)[0]
        rule = tensor.tp_rule(name)
        if rule is None:
            continue
        full = torch.from_numpy(_dense_inv(arr) if arr.ndim == 2 else arr)
        if full.shape[rule[1]] % tp or (rule[0] == "heads" and (full.shape[0] // 3) % tp):
            continue
        parts = [tensor.split(*rule, full, tp, m) for m in range(tp)]
        assert torch.equal(tensor.join(*rule, parts), full), path
        if rule[0] == "heads":  # rank m holds the q, k and v rows of its heads
            width = full.shape[0] // 3
            for m, part in enumerate(parts):
                rows = [full[j * width + m * width // tp:j * width + (m + 1) * width // tp]
                        for j in range(3)]
                assert torch.equal(part, torch.cat(rows)), (path, m)
        split_any += 1
    assert split_any >= 6


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tp", [2, 4])
def test_attention_route_under_tp_is_the_one_process_route(monkeypatch, dtype, tp):
    """ViT-L-14-336's vision qkv (577 tokens, width 1024, 16 heads) takes
    the head-group route; a rank's 3W/tp columns alone would fall under its
    3 MB budget (bf16, or fp32 at tp 4) and take the other: the route stays
    the whole width's."""
    taken = []
    for fn, route in ((attention.MhaHeadGroupFunction, "head_group"),
                      (attention.MhaFunction, "whole_width")):
        monkeypatch.setattr(fn, "apply",
                            lambda qkv, heads, causal, route=route: taken.append(route) or qkv)
    l, width, heads = 577, 1024, 16
    want = attention.use_head_group(l, 3 * width, dtype.itemsize, heads)
    local = torch.zeros((1, l, 3 * width // tp), dtype=dtype, requires_grad=True)
    attention.attention_core(local, heads // tp, tp=tp)
    assert taken == ["head_group" if want else "whole_width"]
    local_route = attention.use_head_group(l, 3 * width // tp, dtype.itemsize, heads // tp)
    if l * 3 * width // tp * dtype.itemsize <= 3 * 1024 * 1024:  # bf16, or fp32 at tp 4
        assert local_route != want
