"""The port's kernels and device-side ops.

Importing this package registers the kernels' forwards as
``torch.library`` custom ops (namespace ``sparsify_clip``:
``mha_fwd``, ``mha_fwd_head_group``, ``ln_qkv_fwd``), which a program
saved by :mod:`sparsify_clip_tpu_torch.export` calls: import it before
``torch.export.load``.  Nothing is built at import; the kernel library
is compiled at the first launch on a card.
"""

from sparsify_clip_tpu_torch.ops import attention, ln_qkv  # noqa: F401  (registers the ops)
