"""One rank of the port's data-parallel tests, in a fresh interpreter.

    python tests/torch_dp_worker.py <job> <plan.json> <out_dir>

with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` in the environment, as ``torchrun`` sets them.  The rank
joins a gloo process group on the CPU through
:func:`sparsify_clip_tpu_torch.parallel.multihost.initialize_distributed`
and runs ``job`` on its rows of the plan's global batches; it writes
``<out_dir>/<job>_rank<r>.npz`` (arrays) and ``.json`` (scalars).  It
imports torch, numpy and the port only: the tests hold what it writes
against the JAX package in their own process.

Jobs: ``losses`` (every ``parallel.dist_losses`` function and the loss
route, value and gradients; on the plan's ``device``), ``train``
(locksteps of the train step), ``layouts`` (the train step on a (data,
model) mesh under tensor parallelism, ZeRO-1, FSDP, the GPipe pipeline
and the gathered GradCache layout, with save and resume; the pipelined
trunk alone), ``eval`` (the sharded eval),
``cli`` (the CLI on a YAML), ``collectives`` (on the card: the
collectives the slice needs, on CUDA tensors over gloo, and the ring hop
both ways).  A plan with
``"device": "cuda"`` puts every rank on the card over gloo.

:func:`spawn` starts the ranks of one world from a test: each gets a
port from ``bind(0)`` and the same timeout, so a hung rendezvous fails
the test instead of waiting out the suite.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(job: str, plan: dict, out_dir: str, world: int, timeout: float = TIMEOUT_S,
          signal_rank: Optional[int] = None, signal_when=None) -> List[dict]:
    """Run ``job`` at ``world`` ranks; return each rank's JSON result,
    with its printed output under ``"output"``.
    ``signal_when()`` (polled while the ranks run) → send SIGTERM to rank
    ``signal_rank`` once it turns true."""
    import signal
    import time

    os.makedirs(out_dir, exist_ok=True)
    plan_path = os.path.join(out_dir, f"{job}_plan.json")
    with open(plan_path, "w") as fh:
        json.dump(plan, fh)
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTEST_XDIST_WORKER")}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1", WANDB_MODE="disabled")
    procs = []
    for rank in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, plan_path, out_dir],
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)), cwd=out_dir,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    try:
        sent = signal_when is None
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{job} at world {world} passed {timeout} s")
            if not sent and signal_when():
                procs[signal_rank].send_signal(signal.SIGTERM)
                sent = True
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outputs = [p.communicate()[0] for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        if p.returncode != 0:
            raise RuntimeError(f"{job} rank {rank}/{world} exited {p.returncode}:\n{out[-4000:]}")
    results = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"{job}_rank{rank}.json")) as fh:
            results.append(dict(json.load(fh), output=outputs[rank]))
    return results


def arrays(out_dir: str, job: str, rank: int) -> Dict[str, np.ndarray]:
    with np.load(os.path.join(out_dir, f"{job}_rank{rank}.npz")) as f:
        return {k: f[k] for k in f.files}


# ------------------------------------------------------------- the rank


def register_test_models() -> None:
    """The cut models the tests train (tests/test_torch_port_sparsify.py's
    ``tiny-1l``, tests/test_torch_port_rn50.py's narrow ResNet)."""
    from sparsify_clip_tpu_torch.models import clip

    reg = clip.MODEL_REGISTRY
    reg.setdefault("tiny-1l", dataclasses.replace(reg["tiny-test"], name="tiny-1l",
                                                  vision_layers=(1,), text_layers=1))
    reg.setdefault("rn50-depth1-test", dataclasses.replace(
        reg["RN50"], name="rn50-depth1-test", vision_layers=(1, 1, 1, 1), image_size=64,
        text_layers=1))
    reg.setdefault("rn50-narrow-test", dataclasses.replace(
        reg["rn50-depth1-test"], name="rn50-narrow-test", embed_dim=32, vision_width=16,
        vision_heads=4, text_width=32, text_heads=2))
    # tests/test_tp_equivalence.py's models (non-4x MLPs in tp-tiny)
    reg.setdefault("tp-tiny", clip.CLIPConfig(
        name="tp-tiny", embed_dim=16, vision_kind="vit", image_size=32, vision_width=32,
        vision_layers=(2,), vision_heads=2, patch_size=16, vocab_size=256, context_length=12,
        text_width=16, text_heads=2, text_layers=2, vision_mlp_hidden=48, text_mlp_hidden=24))
    reg.setdefault("rn-tiny", clip.CLIPConfig(
        name="rn-tiny", embed_dim=16, vision_kind="resnet", image_size=32, vision_width=8,
        vision_layers=(1, 1, 1, 1), vision_heads=4, vocab_size=256, context_length=12,
        text_width=16, text_heads=2, text_layers=2))
    # tests/test_pipeline.py's model: four blocks a tower
    reg.setdefault("pp-tiny", clip.CLIPConfig(
        name="pp-tiny", embed_dim=16, vision_kind="vit", image_size=32, vision_width=32,
        vision_layers=(4,), vision_heads=2, patch_size=16, vocab_size=256, context_length=12,
        text_width=16, text_heads=2, text_layers=4))


def _job_losses(plan, mesh, out):
    """Every dist_losses function and two loss routes on this rank's rows."""
    import torch

    from sparsify_clip_tpu_torch.losses import LossContext, make_loss_fn
    from sparsify_clip_tpu_torch.parallel import dist_losses as dl
    from sparsify_clip_tpu_torch.parallel.mesh import psum

    fns = {
        "global_contrastive": lambda i, t, s: dl.global_contrastive_loss(i, t, s["T"], mesh),
        "ring_infonce": lambda i, t, s: dl.ring_infonce_loss(i, t, s["T"], mesh),
        "global_lunif": lambda i, t, s: dl.global_lunif_loss(i, mesh),
        "ring_lunif": lambda i, t, s: dl.ring_lunif_loss(i, mesh),
        "ring_lunif_centroids": lambda i, t, s: dl.ring_lunif_loss(
            dl.global_normalized_centroids(i, t), mesh),
        "global_lalign": lambda i, t, s: dl.global_lalign_loss(i, t, mesh),
        "global_lalign_alpha3": lambda i, t, s: dl.global_lalign_loss(i, t, mesh, alpha=3.0),
        "global_centroids": lambda i, t, s: psum(
            (dl.global_normalized_centroids(i, t) * s["w"]).sum(), mesh),
        "ring_siglip": lambda i, t, s: dl.ring_siglip_loss(i, t, s["scale"], s["bias"], mesh),
    }
    for loss_type in plan["routes"]:
        fn = make_loss_fn(loss_type)
        fns[f"route/{loss_type}"] = (
            lambda i, t, s, fn=fn: fn(i, t, LossContext(
                temperature=s["T"], warm=False, logit_scale=s["scale"],
                logit_bias=s["bias"], mesh=mesh))[0])
    device = torch.device(plan.get("device", "cpu"))
    only = plan.get("only")
    result = {}
    for case in plan["cases"]:
        with np.load(case["inputs"]) as f:
            img, txt = f["img"], f["txt"]
            weights = f["w"]
        rows = mesh.batch_slice(img.shape[0])
        for name, fn in fns.items():
            if only is not None and name not in only:
                continue

            def leaf(x, grad=True):
                return torch.tensor(x, device=device, requires_grad=grad)

            i, t = leaf(img[rows]), leaf(txt[rows])
            scalars = {"T": leaf(case["temperature"]), "scale": leaf(case["scale"]),
                       "bias": leaf(case["bias"]), "w": leaf(weights[rows], False)}
            loss = fn(i, t, scalars)
            loss.backward()
            key = f"{case['name']}/{name}"
            result[f"{key}/loss"] = float(loss.detach())
            out[f"{key}/dimg"] = i.grad.cpu().numpy()
            out[f"{key}/dtxt"] = (t.grad if t.grad is not None else torch.zeros_like(t)).cpu().numpy()
            for s in ("T", "scale", "bias"):
                g = scalars[s].grad
                result[f"{key}/d{s}"] = 0.0 if g is None else float(g)
    return result


def _job_collectives(plan, mesh, out):
    """Each collective the slice needs, on CUDA tensors over gloo: whether
    it returns the right tensor, or the error it raised; then a ring hop
    and its backward.  (torch 2.11's gloo aborts the process on
    ``batch_isend_irecv`` of CUDA tensors, which no probe can catch, so
    the hop is an ``all_to_all_single``.)"""
    import torch
    import torch.distributed as dist

    from sparsify_clip_tpu_torch.parallel.mesh import all_gather_rows, all_reduce_, ring_hop

    device = torch.device("cuda")
    w, r = mesh.data, mesh.rank
    x = torch.full((3, 2), float(r), device=device)
    probes = {}

    def probe(name, fn, want):
        try:
            got = fn()
            probes[name] = bool(torch.equal(got.cpu(), want))
        except Exception as exc:  # noqa: BLE001 - the point is to record it
            probes[name] = f"{type(exc).__name__}: {exc}".splitlines()[0][:300]

    probe("all_reduce", lambda: all_reduce_(x.clone(), mesh),
          torch.full((3, 2), float(sum(range(w)))))
    probe("all_gather_into_tensor", lambda: all_gather_rows(x, mesh),
          torch.cat([torch.full((3, 2), float(k)) for k in range(w)]))

    def uneven():
        send = [k + 1 for k in range(w)]  # k + 1 rows to rank k
        recv = [r + 1] * w
        src = torch.full((sum(send), 2), float(r), device=device)
        dst = torch.empty((sum(recv), 2), device=device)
        dist.all_to_all_single(dst, src, recv, send)
        return dst

    probe("all_to_all_single_uneven", uneven,
          torch.cat([torch.full((r + 1, 2), float(k)) for k in range(w)]))

    v = torch.full((4, 5), float(r), device=device, requires_grad=True)
    moved = ring_hop(v, mesh)
    (moved * (r + 1)).sum().backward()
    out["hop_forward"] = moved.detach().cpu().numpy()
    out["hop_backward"] = v.grad.cpu().numpy()
    return {"probes": probes, "device": str(moved.device), "backend": mesh.backend}


def _local_rows(batch: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    rows = mesh.batch_slice(batch["images"].shape[0])
    return {k: v[rows] for k, v in batch.items()}


def _job_train(plan, mesh, out):
    """Each case: the same steps as the JAX lockstep, on this rank's rows."""
    import torch

    from sparsify_clip_tpu_torch.checkpoints import load_jax_params
    from sparsify_clip_tpu_torch.config import ExperimentConfig
    from sparsify_clip_tpu_torch.data import synthetic_batch
    from sparsify_clip_tpu_torch.parallel.mesh import digest
    from sparsify_clip_tpu_torch.train import create_train_setup

    result = {}
    for case in plan["cases"]:
        config = ExperimentConfig.from_dict(case["fields"])
        setup = create_train_setup(config, steps_per_epoch=case["steps_per_epoch"],
                                   device="cpu", mesh=mesh)
        with np.load(case["initial"]) as f:
            flat = {k: f[k] for k in f.files}
        params = {k: v for k, v in flat.items() if not k.startswith("batch_stats/")}
        stats = {k[len("batch_stats/"):]: v for k, v in flat.items()
                 if k.startswith("batch_stats/")}
        load_jax_params(setup.model, params, stats or None)
        state, log = setup.state, []
        name = case["name"]
        for seed in case["batch_seeds"]:
            batch = synthetic_batch(config.batch_size, case["image_size"], seed=seed)
            state, metrics = setup.train_step(state, _local_rows(batch, mesh))
            log.append({k: float(v) for k, v in metrics.items()})
            if len(log) == 1 and mesh.rank == 0:  # the statistics after one step
                for k, v in state.model.named_buffers():
                    out[f"{name}/buffers1/{k}"] = v.detach().numpy().copy()
        result[name] = {
            "log": log,
            "digest": digest([p for p in state.model.parameters()]
                             + [b for b in state.model.buffers()]),
        }
        if mesh.rank == 0:
            for k, v in state.model.named_parameters():
                out[f"{name}/params/{k}"] = v.detach().numpy()
            for k, v in state.model.named_buffers():
                out[f"{name}/buffers/{k}"] = v.detach().numpy()
        del setup, state
        torch.cuda.empty_cache() if torch.cuda.is_available() else None
    return result


def _trunk_case(case, out):
    """A pipelined trunk alone (``case["trunk"]``: the Transformer's
    fields, ``stages`` and ``n_micro``) from the JAX scan-layout weights
    and input of ``case["weights"]``: its output and the input's gradient
    of sum(y²) (rank 0), and this rank's blocks' gradients."""
    import torch

    from sparsify_clip_tpu_torch.checkpoints import torch_name, unstack_scan_layers
    from sparsify_clip_tpu_torch.models.layers import Transformer
    from sparsify_clip_tpu_torch.parallel.mesh import create_mesh

    spec = dict(case["trunk"])
    stages, n_micro = spec.pop("stages"), spec.pop("n_micro")
    mesh = create_mesh(model=stages)
    trunk = Transformer(**spec, scan_layers=True, pipeline_stages=stages,
                        pipeline_microbatches=n_micro, mesh=mesh)
    with np.load(case["weights"]) as f:
        flat = {k: f[k] for k in f.files}
    x = torch.from_numpy(flat.pop("x")).requires_grad_(True)
    own = dict(trunk.named_parameters())
    with torch.no_grad():
        for path, arr in unstack_scan_layers(flat).items():
            name, fn = torch_name(path)
            if name in own:
                own[name].copy_(torch.from_numpy(np.ascontiguousarray(fn(arr))))
    y = trunk(x)
    y.square().sum().backward()
    if mesh.rank == 0:
        out[f"{case['name']}/y"] = y.detach().numpy()
        out[f"{case['name']}/dx"] = x.grad.numpy()
    for name, p in own.items():
        out[f"{case['name']}/grad/{name}"] = p.grad.numpy()
    return {"mesh": [mesh.data, mesh.model], "names": sorted(own)}


def _job_layouts(plan, _, out):
    """Each case: the steps of the JAX lockstep on the (data, model) mesh
    of its ``mesh_model``, the model laid out by its config (tensor
    parallelism, ZeRO-1, FSDP, the GPipe pipeline, the gathered GradCache
    layout); the bytes and names of the rank's parameters and the bytes of
    its moments, a digest of the full state, the eval twin's embeddings of
    the held-out batch, and with ``save_at`` a full-state save at that step
    and a resume into a fresh setup that runs the remaining steps again;
    with ``npz`` the weights file; with ``eval`` the metrics of the eval
    twin and of the one-process twin over the held-out and the first
    batch.  A ``trunk`` case runs :func:`_trunk_case`."""
    import torch

    from sparsify_clip_tpu_torch import checkpoints
    from sparsify_clip_tpu_torch.config import ExperimentConfig
    from sparsify_clip_tpu_torch.eval import evaluate_model, make_eval_model
    from sparsify_clip_tpu_torch.parallel.mesh import create_mesh, digest
    from sparsify_clip_tpu_torch.parallel.sharding import layout_of
    from sparsify_clip_tpu_torch.train import create_train_setup, trainables

    with np.load(plan["batches"]) as f:
        data = {k: f[k] for k in f.files}
    n_train = len([k for k in data if k.startswith("images")]) - 1
    result = {}
    for case in plan["cases"]:
        name = case["name"]
        if "trunk" in case:
            result[name] = _trunk_case(case, out)
            continue
        config = ExperimentConfig.from_dict(case["fields"])
        mesh = create_mesh(model=config.mesh_model)

        def fresh():
            setup = create_train_setup(config, steps_per_epoch=case["steps_per_epoch"],
                                       device="cpu", mesh=mesh)
            with np.load(case["initial"]) as f:
                flat = {k: f[k] for k in f.files}
            stats = {k[len("batch_stats/"):]: v for k, v in flat.items()
                     if k.startswith("batch_stats/")}
            checkpoints.load_jax_params(
                setup.model, {k: v for k, v in flat.items() if not k.startswith("batch_stats/")},
                stats or None)
            return setup

        def full_digest(state):
            full = checkpoints.full_parameters(state.model)
            return digest([full[k] for k in sorted(full)] + list(state.model.buffers()))

        def run(setup, first):
            state, log = setup.state, []
            for i in range(first, n_train):
                batch = {"images": data[f"images{i}"], "tokens": data[f"tokens{i}"]}
                if case.get("save_at") == state.step and setup is main:
                    checkpoints.save_full(state, os.path.join(plan["dir"], name))
                state, metrics = setup.train_step(state, _local_rows(batch, mesh))
                log.append({k: float(v) for k, v in metrics.items()})
            return state, log

        main = fresh()
        params_bytes = sum(p.numel() * p.element_size() for p in trainables(main.state))
        state, log = run(main, 0)
        moments = [t for st in state.optimizer.state.values() for k, t in st.items()
                   if k in ("exp_avg", "exp_avg_sq")]
        rec = {"log": log, "digest": full_digest(state), "mesh": [mesh.data, mesh.model],
               "bytes": {"params": params_bytes,
                         "moments": sum(t.numel() * t.element_size() for t in moments)},
               "names": sorted(n for n, _ in state.model.named_parameters())}
        if case.get("save_at") is not None:
            again = fresh()
            checkpoints.restore_full(os.path.join(plan["dir"], name), again.state)
            resumed_state, rec["resumed_log"] = run(again, case["save_at"])
            rec["resumed_digest"] = full_digest(resumed_state)
        if case.get("npz"):
            rec["npz"] = checkpoints.save_weights(
                state.model, os.path.join(plan["dir"], f"{name}_weights.npz"))
        twin = make_eval_model(state.model, True)
        with torch.no_grad():
            img, txt = twin(torch.from_numpy(data[f"images{n_train}"]),
                            torch.from_numpy(data[f"tokens{n_train}"]))
        if mesh.rank == 0:
            out[f"{name}/img"], out[f"{name}/txt"] = img.numpy(), txt.numpy()
        if case.get("eval"):
            batches = [_local_rows({"images": data[f"images{i}"], "tokens": data[f"tokens{i}"]},
                                   mesh) for i in (n_train, 0)]
            one = layout_of(state.model).full_model(state.model, torch.float32).eval()
            rec["eval"] = {"twin": evaluate_model(twin, batches, mesh=mesh),
                           "one_process": evaluate_model(one, batches, mesh=mesh)}
        result[name] = rec
    return result


def _job_eval(plan, mesh, out):
    """The 13 metrics of each case's eval set, each rank encoding its rows."""
    import torch

    from sparsify_clip_tpu_torch.checkpoints import load_jax_params
    from sparsify_clip_tpu_torch.data import synthetic_batch
    from sparsify_clip_tpu_torch.eval import encode_eval_set, evaluate_model, make_eval_model
    from sparsify_clip_tpu_torch.models.clip import create_model

    result = {}
    for case in plan["cases"]:
        model = create_model(case["model"], dtype=getattr(torch, case["dtype"]), device="cpu",
                             param_dtype=torch.float32, seed=0)
        with np.load(case["weights"]) as f:
            load_jax_params(model, {k: f[k] for k in f.files})
        eval_model = make_eval_model(model.train(), True)
        batches = [_local_rows(synthetic_batch(case["batch"], case["image_size"], seed=s), mesh)
                   for s in case["batch_seeds"]]
        result[case["name"]] = evaluate_model(eval_model, batches, mesh=mesh)
        img, txt = encode_eval_set(eval_model, batches, mesh)
        out[f"{case['name']}/img"], out[f"{case['name']}/txt"] = img.numpy(), txt.numpy()
    return result


def _job_cli(plan, mesh, out):
    """The CLI on the plan's YAML, on the CPU."""
    from sparsify_clip_tpu_torch import cli
    from sparsify_clip_tpu_torch.config import load_config

    final = cli.main(load_config(plan["yaml"]), device="cpu")
    return {"final": final}


JOBS = {"losses": _job_losses, "train": _job_train, "eval": _job_eval, "cli": _job_cli,
        "collectives": _job_collectives, "layouts": _job_layouts}


def main(job: str, plan_path: str, out_dir: str) -> None:
    import torch

    from sparsify_clip_tpu_torch.parallel.mesh import create_mesh
    from sparsify_clip_tpu_torch.parallel.multihost import (
        initialize_distributed, shutdown_distributed,
    )

    torch.set_num_threads(1)
    register_test_models()
    with open(plan_path) as fh:
        plan = json.load(fh)
    if job != "cli":  # the CLI joins the process group itself
        initialize_distributed(None, backend="gloo", timeout_s=TIMEOUT_S)
        mesh = create_mesh()
    else:
        mesh = None
    out: Dict[str, np.ndarray] = {}
    result = JOBS[job](plan, mesh, out)
    rank = int(os.environ["RANK"])
    np.savez(os.path.join(out_dir, f"{job}_rank{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"{job}_rank{rank}.json"), "w") as fh:
        json.dump(result, fh)
    shutdown_distributed()


if __name__ == "__main__":
    main(*sys.argv[1:4])
