from sparsify_clip_tpu_torch.data.coco import CocoCaptionIndex, CocoCaptions, Subset
from sparsify_clip_tpu_torch.data.loader import DataLoader
from sparsify_clip_tpu_torch.data.pipeline import dataset_loader
from sparsify_clip_tpu_torch.data.synthetic import SyntheticCaptions, synthetic_batch

__all__ = ["CocoCaptionIndex", "CocoCaptions", "DataLoader", "Subset", "SyntheticCaptions",
           "dataset_loader", "synthetic_batch"]
