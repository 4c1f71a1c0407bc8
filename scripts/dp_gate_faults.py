#!/usr/bin/env python3
"""What ``chip_smoke.py`` phase 41's gates read on broken data-parallel
steps: the readings each gate must tell apart from a sound run.

    python3 scripts/dp_gate_faults.py [--faults grad_mean,no_grad_allreduce,local_bn]

Needs one card.  It builds the kernels, runs phase 41's one-process
references (the exp-6 steps of ``chip_smoke.DP_STEP_RUNS`` at global batch
256), then for each fault two gloo ranks on card 0 run the same steps with
the step broken on purpose (``chip_smoke._dp_fault``):

* ``grad_mean``: the gradient all-reduce averages (DDP's mean), so every
  gradient is 1/W of the global loss's;
* ``no_grad_allreduce``: each rank steps on its own rows' share of the
  gradient;
* ``local_bn``: RN50's BatchNorm statistics over the rank's rows alone.

Prints, a line each, the fault, the step run, every gate's reading and
the gates that fire (``chip_smoke._dp_gates_fired``), then ``nvidia-smi``'s
card name and power limit.  It fails nothing: a fault that fires no gate
is the finding.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FAULTS = {  # fault → the step runs it breaks (local_bn: only a ResNet has BatchNorm)
    "grad_mean": (("ViT-B-32", "bf16"), ("ViT-B-32", "fp32"), ("RN50", "fp32")),
    "no_grad_allreduce": (("ViT-B-32", "bf16"), ("ViT-B-32", "fp32"), ("RN50", "fp32")),
    "local_bn": (("RN50", "fp32"),),
}
WORLD = 2


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--faults", default=",".join(FAULTS))
    args = parser.parse_args()

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("dp_gate_faults: no CUDA device", file=sys.stderr)
        return 1
    faults = args.faults.split(",")
    cs.phase_build()
    runs = sorted({key for f in faults for key in FAULTS[f]})
    ref = cs._dp_references(torch.device("cuda"), [(m, d, (WORLD,)) for m, d in runs], ())
    for fault in faults:
        keys = FAULTS[fault]
        ranks, _, saved, seconds = cs._dp_launch(
            WORLD, [f"step:{m}:{d}" for m, d in keys], fault=fault)
        for key in keys:
            model, dtype = key
            r = cs._dp_step_readings([rk[f"step:{model}:{dtype}"] for rk in ranks], saved[key],
                                     ref["steps"][key], ref["saved"][key], WORLD)
            print(json.dumps(dict(fault=fault, model=model, dtype=dtype, ranks=WORLD,
                                  readings=r, gates_fired=cs._dp_gates_fired(key, r),
                                  launch_seconds=round(seconds, 3))), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
