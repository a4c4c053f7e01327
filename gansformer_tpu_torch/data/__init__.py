from gansformer_tpu_torch.data.dataset import (SyntheticDataset,
                                               normalize_images)

__all__ = ["SyntheticDataset", "normalize_images"]
