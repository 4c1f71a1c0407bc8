"""AdamW with a bf16 first moment: optax's ``adamw(...,
mu_dtype=jnp.bfloat16)`` (the JAX ``build_optimizer``,
sparsify_clip_tpu/train.py:89-106), which ``adam_mu_dtype: bfloat16``
selects.

``torch.optim.AdamW`` keeps ``exp_avg`` in the parameter's dtype and has
no such knob, so this is the optax update in optax's order, with foreach
ops:

* the new first moment is computed in fp32 from the fp32 gradient and the
  stored moment, ``(1 - β1)·g + β1·μ``.  optax multiplies the stored
  moment in its own dtype: the Python ``β1`` is weakly typed, so it is
  cast to bf16 (0.9 → 0.8984375) and ``β1·μ`` is rounded to bf16 before
  the fp32 sum;
* the update is taken from that **unrounded** fp32 moment; only then is
  the moment stored, rounded to bf16 (round-to-nearest-even);
* ν stays fp32: ``(1 - β2)·g² + β2·ν``;
* ``update = (μ / (1 - β1^t)) / (sqrt(ν / (1 - β2^t)) + eps)``, then the
  decoupled weight decay ``update + wd·p`` and ``p - lr·update``.

The update runs over slices of the parameter list of at most
``SLICE_VALUES`` values each.  Its fp32 temporaries (μ, the widened β1·μ,
g², ν̂) then take a slice's worth each rather than the whole model's (for
ViT-bigG-14's 2.54 B parameters about 25 GB less at the step's peak);
every operation is elementwise, so the bits do not depend on the slicing.

The state keys are ``torch.optim.AdamW``'s (``step``, ``exp_avg``,
``exp_avg_sq``), and :meth:`load_state_dict` keeps ``exp_avg`` in its
dtype, so a ``state_dict`` round-trips through ``torch.save`` bit for
bit (the base class would cast it to the parameter's fp32).
"""

from __future__ import annotations

import torch

SLICE_VALUES = 1 << 28  # 1 GiB of fp32 a temporary


def _slices(params, limit: int):
    """``params`` in order, cut into runs of at most ``limit`` values (a
    larger tensor alone)."""
    run, size = [], 0
    for p in params:
        if run and size + p.numel() > limit:
            yield run
            run, size = [], 0
        run.append(p)
        size += p.numel()
    if run:
        yield run


class AdamWBf16Mu(torch.optim.Optimizer):
    """optax ``adamw`` with ``mu_dtype=jnp.bfloat16`` (see the module
    docstring)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamWBf16Mu.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32)
                    state["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                state["step"] += 1
            count = int(self.state[params[0]]["step"])
            for run in _slices(params, SLICE_VALUES):
                self._update(run, group, count)
        return None

    def _update(self, params, group, count: int) -> None:
        b1, b2 = group["betas"]
        states = [self.state[p] for p in params]
        grads = [p.grad.float() for p in params]
        mus = [s["exp_avg"] for s in states]
        nus = [s["exp_avg_sq"] for s in states]

        # μ in fp32 from g and β1·μ taken in bf16, as optax does
        mu = torch._foreach_mul(grads, 1.0 - b1)
        decayed = torch._foreach_mul(mus, float(torch.tensor(b1, dtype=torch.bfloat16)))
        torch._foreach_add_(mu, [d.float() for d in decayed])
        del decayed
        torch._foreach_mul_(nus, b2)
        squares = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(squares, 1.0 - b2)
        torch._foreach_add_(nus, squares)
        del squares
        torch._foreach_copy_(mus, mu)  # stored rounded; the update uses the fp32 μ

        torch._foreach_div_(mu, 1.0 - b1 ** count)            # μ̂
        denom = torch._foreach_div(nus, 1.0 - b2 ** count)    # ν̂
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        torch._foreach_div_(mu, denom)
        del denom
        torch._foreach_add_(mu, params, alpha=group["weight_decay"])
        torch._foreach_add_(params, mu, alpha=-group["lr"])

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for state in self.state.values():
            if "exp_avg" in state:
                state["exp_avg"] = state["exp_avg"].to(torch.bfloat16)
