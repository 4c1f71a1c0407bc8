#!/usr/bin/env python3
"""Which collectives this torch build's gloo backend takes on CUDA tensors.

    python3 scripts/probe_gloo_cuda.py [--out FILE]

Needs one card.  Each collective runs in its own two-process group
(``python -m torch.distributed.run --standalone --nproc_per_node=2``),
both ranks on card 0 with every tensor on the card, so that one which
aborts its process (gloo raises some faults as a C++ exception) spoils
no other reading.  Each probe checks the values it received.  The probes:
``all_reduce``, ``all_gather_into_tensor``, ``broadcast``,
``all_to_all_single`` with one nonzero split each way (the ring hop of
``sparsify_clip_tpu_torch.parallel.mesh``), ``batch_isend_irecv``
(send to rank + 1, receive from rank − 1), ``reduce_scatter_tensor``
(FSDP's gradient exchange), and ``subgroups_2x2``: four ranks as a
2 × 2 (data, model) mesh, every one of the collectives above but the
send/receive pair over each rank's data group and model group
(``dist.new_group``), as ``sparsify_clip_tpu_torch.parallel.mesh`` runs
them.  Prints one JSON object: the
torch and CUDA versions, the card count, and for each probe its exit code,
whether every rank received the right values, and its error (a C++
abort's message, else the last error line); with ``--out``, writes it
there too.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PROBES = ("all_reduce", "all_gather_into_tensor", "broadcast", "all_to_all_single_uneven",
          "batch_isend_irecv", "reduce_scatter_tensor", "subgroups_2x2")
RANKS = {"subgroups_2x2": 4}  # processes a probe takes; 2 for the others
TIMEOUT = 120  # seconds a probe


def rank_main(probe: str) -> int:
    """One rank of ``probe``: prints ``probe ok`` when its values are right."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo")
    r, w = dist.get_rank(), dist.get_world_size()
    torch.cuda.set_device(0)
    x = torch.full((4, 3), float(r + 1), device="cuda")
    if probe == "all_reduce":
        dist.all_reduce(x)
        ok = bool((x == w * (w + 1) / 2).all())
    elif probe == "all_gather_into_tensor":
        out = torch.empty((4 * w, 3), device="cuda")
        dist.all_gather_into_tensor(out, x)
        ok = all(bool((out[4 * k:4 * k + 4] == k + 1).all()) for k in range(w))
    elif probe == "broadcast":
        dist.broadcast(x, src=0)
        ok = bool((x == 1).all())
    elif probe == "all_to_all_single_uneven":
        send, recv = [0] * w, [0] * w
        send[(r + 1) % w], recv[(r - 1) % w] = 4, 4
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, output_split_sizes=recv, input_split_sizes=send)
        ok = bool((out == (r - 1) % w + 1).all())
    elif probe == "batch_isend_irecv":
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (r + 1) % w), dist.P2POp(dist.irecv, out, (r - 1) % w)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        ok = bool((out == (r - 1) % w + 1).all())
    elif probe == "reduce_scatter_tensor":
        big = torch.arange(4 * w * 3, dtype=torch.float32, device="cuda").reshape(4 * w, 3) + r
        dist.reduce_scatter_tensor(x, big)
        want = (torch.arange(4 * w * 3, dtype=torch.float32, device="cuda").reshape(4 * w, 3)
                * w + w * (w - 1) / 2)[4 * r:4 * r + 4]
        ok = bool((x == want).all())
    elif probe == "subgroups_2x2":
        ok = _subgroups(dist, torch, r)
    else:
        raise ValueError(probe)
    torch.cuda.synchronize()
    print(f"{probe} {'ok' if ok else 'wrong values'}", flush=True)
    dist.destroy_process_group()
    return 0 if ok else 1


def _subgroups(dist, torch, r: int) -> bool:
    """World rank = data_rank · 2 + model_rank; every rank builds every group."""
    groups = {("data", m): dist.new_group([m, 2 + m]) for m in range(2)}
    groups.update({("model", d): dist.new_group([2 * d, 2 * d + 1]) for d in range(2)})
    d, m = divmod(r, 2)
    ok = True
    for axis, g, members in (("data", groups[("data", m)], [m, 2 + m]),
                             ("model", groups[("model", d)], [2 * d, 2 * d + 1])):
        me = members.index(r)
        x = torch.full((4, 3), float(r + 1), device="cuda")
        dist.all_reduce(x, group=g)
        ok &= bool((x == sum(k + 1 for k in members)).all())
        x = torch.full((4, 3), float(r + 1), device="cuda")
        out = torch.empty((8, 3), device="cuda")
        dist.all_gather_into_tensor(out, x, group=g)
        ok &= all(bool((out[4 * k:4 * k + 4] == members[k] + 1).all()) for k in range(2))
        big = torch.full((8, 3), float(r + 1), device="cuda")
        dist.reduce_scatter_tensor(x, big, group=g)
        ok &= bool((x == sum(k + 1 for k in members)).all())
        x = torch.full((4, 3), float(r + 1), device="cuda")
        dist.broadcast(x, src=members[0], group=g)
        ok &= bool((x == members[0] + 1).all())
        x = torch.full((4, 3), float(r + 1), device="cuda")
        send, recv = [0, 0], [0, 0]
        send[(me + 1) % 2], recv[(me - 1) % 2] = 4, 4
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, output_split_sizes=recv, input_split_sizes=send, group=g)
        ok &= bool((out == members[(me - 1) % 2] + 1).all())
        print(f"subgroups_2x2 {axis} {'ok' if ok else 'wrong values'}", flush=True)
    return ok


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_gloo_cuda: no CUDA device", file=sys.stderr)
        return 1
    result = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device_count": torch.cuda.device_count(), "probes": {}}
    for probe in PROBES:
        try:
            p = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                f"--nproc_per_node={RANKS.get(probe, 2)}",
                                os.path.abspath(__file__), "--rank", probe],
                               capture_output=True, text=True, timeout=TIMEOUT)
            rc, out, err = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as exc:
            rc, out, err = "timeout", exc.stdout or "", exc.stderr or ""
            out, err = (s.decode() if isinstance(s, bytes) else s for s in (out, err))
        # a C++ abort's message first, else the last Python error line
        lines = err.splitlines()
        errors = ([line for line in lines if "what()" in line]
                  or [line for line in lines if "Error" in line][-1:] or [""])
        ranks = RANKS.get(probe, 2)
        result["probes"][probe] = {"rc": rc, "ok": rc == 0 and out.count(f"{probe} ok") == ranks,
                                   "error": errors[0].strip()[:300]}
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2]))
    sys.exit(main())
