from cspn_monodepth_tpu_torch.data.datasets import (
    KITTIDataset,
    NYUDataset,
    PackedNYUDataset,
    SyntheticDataset,
    make_dataset,
)
from cspn_monodepth_tpu_torch.data.pipeline import (
    DEPTH_SCALE,
    device_prefetch,
    make_eval_iterator,
    make_train_iterator,
    pack_batch,
)

__all__ = [
    "KITTIDataset",
    "NYUDataset",
    "PackedNYUDataset",
    "SyntheticDataset",
    "make_dataset",
    "DEPTH_SCALE",
    "pack_batch",
    "make_train_iterator",
    "make_eval_iterator",
    "device_prefetch",
]
