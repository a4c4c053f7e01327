from gansformer_tpu_torch.data.dataset import (Dataset, ImageFolderDataset,
                                               NpzDataset, PrefetchIterator,
                                               SyntheticDataset,
                                               TFRecordDataset, make_dataset,
                                               normalize_images)
from gansformer_tpu_torch.data.errors import DataCorrupt, DataStalled
from gansformer_tpu_torch.data.tfrecord_writer import (TFRecordExporter,
                                                       export_images,
                                                       iter_lsun_lmdb,
                                                       load_cifar10)

__all__ = ["DataCorrupt", "DataStalled", "Dataset", "ImageFolderDataset",
           "NpzDataset", "PrefetchIterator", "SyntheticDataset",
           "TFRecordDataset", "TFRecordExporter", "export_images",
           "iter_lsun_lmdb", "load_cifar10", "make_dataset",
           "normalize_images"]
