"""Parallelism over processes, ported from :mod:`sparsify_clip_tpu.parallel`:
the (data, model) mesh and its collectives (:mod:`.mesh`), joining the
process group and the per-process batch slices (:mod:`.multihost`), the
global-batch losses from per-rank shards (:mod:`.dist_losses`), tensor
parallelism (:mod:`.tensor`) or GPipe's stages (:mod:`.pipeline`) on the
model axis, and ZeRO-1 and FSDP on the data axis (:mod:`.sharding`)."""

from sparsify_clip_tpu_torch.parallel.dist_losses import (  # noqa: F401
    global_contrastive_loss,
    global_lalign_loss,
    global_lunif_loss,
    global_normalized_centroids,
    ring_infonce_loss,
    ring_lunif_loss,
    ring_siglip_loss,
)
from sparsify_clip_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_gather,
    all_reduce_gradients,
    create_mesh,
)
from sparsify_clip_tpu_torch.parallel.multihost import (  # noqa: F401
    allgather_to_host,
    any_process_flag,
    initialize_distributed,
    is_primary,
)
