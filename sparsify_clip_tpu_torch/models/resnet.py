"""Modified ResNet vision tower (the RN50 family), ported from
:mod:`sparsify_clip_tpu.models.resnet`.

CLIP's "ModifiedResNet", as on the JAX side:

* a 3-conv stem (3 → w/2 → w/2 → w channels, the first conv stride 2),
  then a 2×2 average pool;
* anti-aliased downsampling: a stride-2 block runs its 3×3 conv at
  stride 1 and then a 2×2 average pool, in the residual branch and in
  the shortcut;
* an attention pool at the end, whose query is the spatial mean.

The public input is NHWC, as on the JAX side.  ``images.permute(0, 3, 1,
2)`` is a channels_last view of it, and the tower keeps that layout end
to end: cuDNN runs every conv in NHWC, and each 1×1 conv that carries a
folded BatchNorm (:class:`FoldedConvBN`) is one GEMM over the contiguous
(B·H·W, C) view, with no copy.

Parameter and buffer names are open_clip's ModifiedResNet ones
(``conv1``/``bn1`` stem, ``layer{s}.{i}.conv1``, ``downsample.0`` /
``downsample.1``, ``attnpool.*``); BatchNorm keeps ``running_mean`` and
``running_var`` and has no ``num_batches_tracked``.  Every BatchNorm
statistic and parameter is fp32 whatever the compute type.  The JAX
side calls no ``pallas_call`` here: its convs, BatchNorm and attention
pool are XLA, and the port's are cuDNN, cuBLAS and PyTorch's own
elementwise kernels.

``remat`` runs each ``Bottleneck`` under a checkpoint when a gradient is
taken (the JAX per-block ``nn.remat``, resnet.py:561-570).  Its
recompute normalizes by the same batch statistics and leaves the running
statistics alone: they move once, in the forward, as under JAX's remat.

Over a data-parallel mesh of W > 1 ranks (:func:`set_data_parallel`)
every train-mode BatchNorm takes its statistics over the **global**
batch, as the JAX global-view step does (resnet.py:82-83): the fp32 sums
are all-reduced in the forward and the two per-channel sums of the
gradient in the backward, and the running statistics stay identical on
every rank.  One rank runs the single-device code unchanged.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sparsify_clip_tpu_torch.models.layers import (
    _lecun_normal_, _normal_, linear, remat, resolve_remat_policy, row_linear,
)
from sparsify_clip_tpu_torch.parallel.mesh import Mesh, all_reduce_, psum, pvary
from sparsify_clip_tpu_torch.parallel.tensor import copy_to_model


def _conv(x: torch.Tensor, weight: torch.Tensor, **kwargs) -> torch.Tensor:
    """A bias-free conv with the fp32 kernel cast to the activations' type
    at use, as flax's ``nn.Conv(dtype=...)``."""
    return F.conv2d(x, weight.to(x.dtype), **kwargs)


class BatchNormHalf(nn.Module):
    """BatchNorm with fp32 statistics and compute-dtype normalization
    (the JAX ``BatchNormHalf``, resnet.py:33-97), over NCHW-shaped input.

    In train mode the batch statistics are taken in fp32 with flax's fast
    variance E[x²] − E[x]²; the normalization is ``x·inv + shift`` in x's
    type, with ``inv`` and ``shift`` cast down once.  The running
    statistics follow flax's momentum convention (``ra = 0.9·ra +
    0.1·batch``) and track the unbiased variance n/(n−1), as
    ``torch.nn.BatchNorm2d`` does; they are updated in place, so a twin
    that shares the buffers (``CLIP.with_dtype``) sees every update.  In
    eval mode the running statistics normalize.  The backward is autograd
    through the batch statistics, as on the JAX side.
    """

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.mesh: Optional[Mesh] = None  # set_data_parallel: global statistics

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        with torch.no_grad():
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    @torch.no_grad()
    def update_running_stats(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        """One momentum step of the running statistics from a batch's
        biased ``mean`` and ``var`` over ``n`` values a channel."""
        m = self.momentum
        self.running_mean.mul_(m).add_(mean.detach() * (1 - m))
        self.running_var.mul_(m).add_(var.detach() * (n / max(n - 1, 1)) * (1 - m))

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        """``update_stats=False`` normalizes as in train mode without the
        momentum step (a checkpoint's recompute)."""
        if self.training:
            xf = x.float()
            n = x.numel() // x.shape[1]
            if _spans_ranks(self.mesh):
                # fp32 sums over the global batch; the backward all-reduces
                # the gradient's two per-channel sums through the same op
                sums = torch.stack([xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3))])
                sums = pvary(psum(sums, self.mesh), self.mesh)
                n *= self.mesh.data
                mean = sums[0] / n
                var = sums[1] / n - mean.square()
            else:
                mean = xf.mean((0, 2, 3))
                var = xf.square().mean((0, 2, 3)) - mean.square()
            if update_stats:
                self.update_running_stats(mean, var, n)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * inv
        return torch.addcmul(shift.to(x.dtype)[:, None, None], x, inv.to(x.dtype)[:, None, None])


class FoldedConvBN(torch.autograd.Function):
    """A 1×1 conv and a train-mode BatchNorm with the norm folded into the
    conv's weights (the JAX ``_folded_train`` custom VJP, resnet.py:151-273).

    ``h = x @ W`` is linear, so the batch statistics of ``h`` come from the
    input's moments: ``mean(h) = m_x @ W`` and ``E[h²]_o = W[:, o]ᵀ ·
    E[x xᵀ] · W[:, o]``, with the (K, K) second moment taken in fp32 from
    the exact products of x's values; ``h`` is never materialized.

    ``apply(x, w, scale, bias, eps, mesh)``: x (n, K) in the compute type,
    w (K, C), scale and bias (C,) fp32 → ``(y, mean, var)``: y (n, C) in
    x's type, and the biased batch mean and variance of ``h``, fp32.  ``mean``
    and ``var`` feed only the running statistics and are marked
    non-differentiable (the JAX VJP raises when they are differentiated).
    The backward is the JAX side's analytic form: every reduction
    collapses onto ``t = xᵀ g``, and the rest is (K, K) and (K, C) algebra.

    Over W > 1 ranks (``mesh``) the statistics are the global batch's: the
    forward all-reduces x's sum and (K, K) second moment, the backward the
    two per-channel sums ``s1 = Σ g`` and ``s2 = Σ g·ĥ``.  Every other term
    of ``dw`` and the gradients of ``scale`` and ``bias`` are linear in the
    rows, so each rank returns its rows' share of them (the moments of its
    own rows over the global count) and the step's gradient all-reduce adds
    the shares up.
    """

    @staticmethod
    def forward(ctx, x, w, scale, bias, eps: float, mesh: Optional[Mesh] = None):
        n = x.shape[0]
        xf = x.float()
        ranks = _spans_ranks(mesh)
        if ranks:
            # this rank's share of the moments, then the global ones
            n *= mesh.data
            k = xf.shape[1]
            m_x_own = xf.sum(0) / n
            second_own = (xf.t() @ xf) / n
            moments = all_reduce_(torch.cat([m_x_own, second_own.reshape(-1)]), mesh)
            m_x, second = moments[:k], moments[k:].view(k, k)
        else:
            m_x = xf.mean(0)
            second = (xf.t() @ xf) / n
        mean = m_x @ w
        var = ((second @ w) * w).sum(0) - mean.square()
        inv = torch.rsqrt(var + eps)
        d = inv * scale
        y = torch.addmm((bias - mean * d).to(x.dtype), x, (w * d).to(x.dtype))
        if ranks:
            m_x, second = m_x_own, second_own
        ctx.mesh, ctx.n = (mesh if ranks else None), n
        ctx.save_for_backward(x, w, scale, m_x, second, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, w, scale, m_x, second, mean, inv = ctx.saved_tensors
        n, dt = ctx.n, x.dtype
        d = inv * scale
        t = x.float().t() @ gy.float()  # (K, C)
        s1 = gy.sum(0, dtype=torch.float32)
        s2 = ((w * t).sum(0) - mean * s1) * inv  # Σ g·ĥ
        s1_all, s2_all = s1, s2
        if ctx.mesh is not None:
            c = s1.shape[0]
            sums = all_reduce_(torch.cat([s1, s2]), ctx.mesh)
            s1_all, s2_all = sums[:c], sums[c:]
        q = inv * d * s2_all / n
        a_small = (w * q) @ w.t()  # (K, K)
        r = w @ (mean * q - d * s1_all / n)  # (K,)
        dx = torch.addmm(r.to(dt), gy, (w * d).to(dt).t()) - x @ a_small.to(dt)
        dw = (t * d - torch.outer(m_x, d * s1_all)
              - (second @ w - torch.outer(m_x, mean)) * (inv * d * s2_all))
        return dx, dw, s2, s1, None, None


def _spans_ranks(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.data > 1


def set_data_parallel(model: nn.Module, mesh: Optional[Mesh]) -> None:
    """Make every :class:`BatchNormHalf` of ``model`` take its train-mode
    statistics over ``mesh``'s global batch (None: the rank's own batch)."""
    for module in model.modules():
        if isinstance(module, BatchNormHalf):
            module.mesh = mesh


def _as_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → the (B·H·W, C) rows: a view of a channels_last x."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


def _from_rows(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    b, _, h, w = like.shape
    return y.view(b, h, w, y.shape[1]).permute(0, 3, 1, 2)


def conv1x1_bn(x: torch.Tensor, weight: torch.Tensor, bn: BatchNormHalf,
               update_stats: bool = True) -> torch.Tensor:
    """The folded 1×1 conv + BatchNorm (the JAX ``_conv1x1_bn_folded``,
    resnet.py:276-335): :class:`FoldedConvBN` in train mode, with one
    momentum step of ``bn``'s running statistics unless ``update_stats``
    is off; in eval mode the running statistics fold into the conv's
    weights."""
    rows = _as_rows(x)
    w = weight.view(weight.shape[0], -1).t()  # (K, C) fp32
    if bn.training:
        y, mean, var = FoldedConvBN.apply(rows, w, bn.weight, bn.bias, bn.eps, bn.mesh)
        if update_stats:
            ranks = bn.mesh.data if _spans_ranks(bn.mesh) else 1
            bn.update_running_stats(mean, var, rows.shape[0] * ranks)
    else:
        inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        y = torch.addmm((bn.bias - bn.running_mean * inv).to(x.dtype), rows,
                        (w * inv).to(x.dtype))
    return _from_rows(y, x)


def conv1x1_bn_plain(x: torch.Tensor, weight: torch.Tensor, bn: BatchNormHalf) -> torch.Tensor:
    """The unfolded conv → :class:`BatchNormHalf` that :func:`conv1x1_bn`
    computes (the JAX ``fold_bn3=False`` route); the tests hold the fold
    against it."""
    return bn(_conv(x, weight))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, remat: bool = False,
                 remat_policy: Optional[str] = None):
        super().__init__()
        out_ch = planes * self.expansion
        self.stride = stride
        self.remat = remat
        self.policy = resolve_remat_policy(remat_policy) if remat else None
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNormHalf(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNormHalf(planes)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = BatchNormHalf(out_ch)
        self.downsample = None
        if stride > 1 or inplanes != out_ch:
            self.downsample = nn.Sequential(OrderedDict([
                ("0", nn.Conv2d(inplanes, out_ch, 1, bias=False)),
                ("1", BatchNormHalf(out_ch)),
            ]))

    def reset_parameters(self, gen: torch.Generator) -> None:
        for conv in (self.conv1, self.conv2, self.conv3):
            _lecun_normal_(conv.weight, conv.weight[0].numel(), gen)
        for bn in (self.bn1, self.bn2, self.bn3):
            bn.reset_parameters()
        if self.downsample is not None:
            _lecun_normal_(self.downsample[0].weight, self.downsample[0].weight[0].numel(), gen)
            self.downsample[1].reset_parameters()

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        return self._forward(x, update_stats)

    def checkpointed(self, x: torch.Tensor) -> torch.Tensor:
        """The block under :func:`remat`: the recompute calls the module
        again (so a sharded block gathers its weights again) and leaves the
        running statistics alone."""
        calls = []

        def run(x):
            # the first call is the forward, a later one the recompute
            calls.append(None)
            return self(x, len(calls) == 1)

        return remat(run, self.policy, x)

    def _forward(self, x: torch.Tensor, update_stats: bool) -> torch.Tensor:
        out = torch.relu(self.bn1(_conv(x, self.conv1.weight), update_stats))
        out = torch.relu(self.bn2(_conv(out, self.conv2.weight, padding=1), update_stats))
        identity = x
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
            identity = F.avg_pool2d(identity, self.stride)
        out = conv1x1_bn(out, self.conv3.weight, self.bn3, update_stats)
        if self.downsample is not None:
            identity = conv1x1_bn(identity, self.downsample[0].weight, self.downsample[1],
                                  update_stats)
        return torch.relu(out + identity)


class AttentionPool2d(nn.Module):
    """Spatial attention pooling whose query is the mean over positions
    (the JAX ``AttentionPool2d``, resnet.py:449-489): scores in fp32 from
    compute-dtype q and k, the softmax in fp32, cast back before attn·v.
    Under tensor parallelism (``tp``) ``c_proj`` is row-parallel, as the
    JAX rules split it: each model rank multiplies its block of the
    (replicated) pooled features by its rows of the weight, and the
    partial products are summed."""

    tp = None  # the mesh whose model axis splits c_proj's input features

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim ** 2 + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def reset_parameters(self, gen: torch.Generator) -> None:
        c = self.positional_embedding.shape[1]
        _normal_(self.positional_embedding, c ** -0.5, gen)
        for proj in (self.k_proj, self.q_proj, self.v_proj, self.c_proj):
            _lecun_normal_(proj.weight, proj.in_features, gen)
            nn.init.zeros_(proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, h, w) → (B, output_dim) in x's type."""
        b, c = x.shape[:2]
        x = _as_rows(x).view(b, -1, c)  # (h, w) flattened row-major
        x = torch.cat([x.mean(1, keepdim=True), x], dim=1)  # the mean token first
        x = x + self.positional_embedding.to(x.dtype)
        heads, head_dim = self.num_heads, c // self.num_heads
        q = linear(x[:, :1], self.q_proj.weight, self.q_proj.bias).view(b, 1, heads, head_dim)
        k = linear(x, self.k_proj.weight, self.k_proj.bias).view(b, -1, heads, head_dim)
        v = linear(x, self.v_proj.weight, self.v_proj.bias).view(b, -1, heads, head_dim)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * head_dim ** -0.5
        attn = scores.softmax(-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, 1, c)
        if self.tp is not None and self.tp.model > 1:
            part = c // self.tp.model
            lo = self.tp.model_rank * part
            out = copy_to_model(out, self.tp)[..., lo:lo + part]
        return row_linear(out, self.c_proj.weight, self.c_proj.bias, self.tp)[:, 0]


def feature_size(image_size: int, stages: int) -> int:
    """The side of the last stage's feature map: the stem's stride-2 conv
    (padding 1) and 2×2 pool, then a 2×2 pool in each stage after the first."""
    side = (image_size - 1) // 2 + 1
    for _ in range(stages):
        side //= 2
    return side


class ModifiedResNet(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 image_size: int = 224, embed_dim: int = 1024, heads: int = 32,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 remat_policy: Optional[str] = None):
        super().__init__()
        self.dtype = dtype  # the compute type; weights are cast to it at use
        self.image_size = image_size
        self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNormHalf(width // 2)
        self.conv2 = nn.Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
        self.bn2 = BatchNormHalf(width // 2)
        self.conv3 = nn.Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = BatchNormHalf(width)
        self.stages = len(layers)
        inplanes, planes = width, width
        for stage, blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            stage_blocks = []
            for block in range(blocks):
                stage_blocks.append(Bottleneck(inplanes, planes, stride if block == 0 else 1,
                                               remat, remat_policy))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*stage_blocks))
            planes *= 2
        self.attnpool = AttentionPool2d(feature_size(image_size, len(layers)), width * 32,
                                        heads, embed_dim)

    def blocks(self) -> Tuple[Bottleneck, ...]:
        return tuple(b for s in range(self.stages) for b in getattr(self, f"layer{s + 1}"))

    def folded_convs(self) -> Tuple[nn.Conv2d, ...]:
        """The 1×1 convs whose BatchNorm folds into their kernel
        (:func:`conv1x1_bn`): conv3 and the downsample conv of each block."""
        convs = []
        for block in self.blocks():
            convs.append(block.conv3)
            if block.downsample is not None:
                convs.append(block.downsample[0])
        return tuple(convs)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)):
            _lecun_normal_(conv.weight, conv.weight[0].numel(), gen)
            bn.reset_parameters()
        for block in self.blocks():
            block.reset_parameters(gen)
        self.attnpool.reset_parameters(gen)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3) float → (B, embed_dim) fp32, unnormalized."""
        size = self.image_size
        if tuple(images.shape[1:]) != (size, size, 3):
            raise ValueError(f"expected (B, {size}, {size}, 3) images, got {tuple(images.shape)}")
        x = _conv(images.to(self.dtype).permute(0, 3, 1, 2), self.conv1.weight, stride=2,
                  padding=1)
        x = torch.relu(self.bn1(x))
        x = torch.relu(self.bn2(_conv(x, self.conv2.weight, padding=1)))
        x = torch.relu(self.bn3(_conv(x, self.conv3.weight, padding=1)))
        x = F.avg_pool2d(x, 2)
        for block in self.blocks():
            x = block.checkpointed(x) if block.remat and torch.is_grad_enabled() else block(x)
        return self.attnpool(x).float()
