"""The port's ring losses and ring hop at 2 ranks on one card, over gloo
with every tensor on the card, against the single-process kernels.

Two processes (``tests/torch_dp_worker.py``) share card 0: NCCL refuses
two ranks on one device, gloo moves CUDA tensors through the host.  The
``collectives`` job checks the collectives the slice needs on CUDA
tensors (``all_reduce``, ``all_gather_into_tensor``,
``all_to_all_single`` with uneven splits) and moves a card tensor one
ring hop forward and its gradient back; the
``losses`` job runs ``ring_infonce_loss``, ``ring_lunif_loss`` (alone and
on the centroids) and the gathered SigLIP route at global (256, 512)
fp32, held against the InfoNCE and uniformity kernels (rows 5-9) and the
plain ``siglip_loss`` on the whole batch on the card.  Tolerances: the
CPU tests' (tests/test_torch_port_dist_losses.py): values rtol 1e-5,
gradients rtol 1e-4 atol 1e-6, scalar gradients rtol 1e-4.

Every test needs a CUDA device and skips without one.  This file imports
no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda_dist.py -q
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dp_worker  # noqa: E402

pytestmark = pytest.mark.cuda

WORLD = 2
N, D = 256, 512
T0, SCALE0, BIAS0 = 0.1, 10.0, -10.0
VALUE_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
SCALAR_RTOL = 1e-4
FNS = ("ring_infonce", "ring_lunif", "ring_lunif_centroids", "route/siglip")


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs():
    rng = np.random.default_rng(11)

    def unit():
        x = rng.standard_normal((N, D)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    return dict(img=unit(), txt=unit(), w=np.zeros((N, D), np.float32))


@pytest.fixture(scope="module")
def collectives(device, tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("collectives"))
    results = torch_dp_worker.spawn("collectives", {}, directory, WORLD)
    record = os.environ.get("CUDA_DIST_RECORD")
    if record:  # the probes' readings, for the records
        with open(record, "w") as fh:
            json.dump([r["probes"] for r in results], fh)
    return results, [torch_dp_worker.arrays(directory, "collectives", r) for r in range(WORLD)]


@pytest.fixture(scope="module")
def losses(device, tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("losses"))
    path = os.path.join(directory, "inputs.npz")
    np.savez(path, **_inputs())
    plan = dict(device="cuda", only=list(FNS), routes=["siglip"],
                cases=[dict(name="n256", inputs=path, temperature=T0, scale=SCALE0, bias=BIAS0)])
    results = torch_dp_worker.spawn("losses", plan, directory, WORLD)
    return results, [torch_dp_worker.arrays(directory, "losses", r) for r in range(WORLD)]


def test_the_ranks_ran_on_the_card_over_gloo(collectives):
    results, _ = collectives
    assert all(r["device"].startswith("cuda") and r["backend"] == "gloo" for r in results)


@pytest.mark.parametrize("name", ["all_reduce", "all_gather_into_tensor",
                                  "all_to_all_single_uneven"])
def test_gloo_takes_the_slices_collectives_on_card_tensors(collectives, name):
    results, _ = collectives
    assert all(r["probes"][name] is True for r in results), [r["probes"] for r in results]


def test_ring_hop_moves_card_tensors_both_ways(collectives):
    _, arrays = collectives
    for rank, a in enumerate(arrays):
        # forward: rank r receives rank r-1's rows; backward: the gradient
        # of rank r+1's use (weight r+2) comes back
        assert (a["hop_forward"] == float((rank - 1) % WORLD)).all()
        assert (a["hop_backward"] == float((rank + 1) % WORLD + 1)).all()


def _reference(name, device):
    from sparsify_clip_tpu_torch.losses import normalized_centroids, siglip_loss
    from sparsify_clip_tpu_torch.ops import infonce, lunif

    x = _inputs()
    img = torch.tensor(x["img"], device=device, requires_grad=True)
    txt = torch.tensor(x["txt"], device=device, requires_grad=True)
    scalars = {k: torch.tensor(v, device=device, requires_grad=True)
               for k, v in (("T", T0), ("scale", SCALE0), ("bias", BIAS0))}
    before = (infonce.infonce_fwd.launches, lunif.lunif_fwd.launches)
    if name == "ring_infonce":
        loss = infonce.infonce_loss(img, txt, scalars["T"])
    elif name == "ring_lunif":
        loss = lunif.lunif_loss(img)
    elif name == "ring_lunif_centroids":
        loss = lunif.lunif_loss(normalized_centroids(img, txt))
    else:
        loss = siglip_loss(img, txt, scalars["scale"], scalars["bias"])
    loss.backward()
    launched = (infonce.infonce_fwd.launches, lunif.lunif_fwd.launches) != before
    grads = {k: (0.0 if v.grad is None else float(v.grad)) for k, v in scalars.items()}
    txt_grad = txt.grad if txt.grad is not None else torch.zeros_like(txt)
    return float(loss), img.grad.cpu().numpy(), txt_grad.cpu().numpy(), grads, launched


@pytest.mark.parametrize("name", FNS)
def test_ring_losses_match_the_kernels_on_the_whole_batch(losses, device, name):
    results, arrays = losses
    key = f"n256/{name}"
    want, want_i, want_t, scalars, launched = _reference(name, device)
    assert launched == (name != "route/siglip")  # rows 5-9 ran on the reference side
    values = [r[f"{key}/loss"] for r in results]
    assert len(set(values)) == 1 and values[0] == pytest.approx(want, rel=VALUE_RTOL)
    np.testing.assert_allclose(np.concatenate([a[f"{key}/dimg"] for a in arrays]), want_i,
                               **GRAD_TOL)
    np.testing.assert_allclose(np.concatenate([a[f"{key}/dtxt"] for a in arrays]), want_t,
                               **GRAD_TOL)
    for s in {"ring_infonce": ("T",), "route/siglip": ("scale", "bias")}.get(name, ()):
        got = [r[f"{key}/d{s}"] for r in results]
        assert len(set(got)) == 1 and got[0] == pytest.approx(scalars[s], rel=SCALAR_RTOL), s
