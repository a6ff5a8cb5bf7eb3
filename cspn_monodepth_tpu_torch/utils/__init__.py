from cspn_monodepth_tpu_torch.utils.logging import (
    CSVLogger,
    colored_depthmap,
    merge_into_row,
    save_image,
)
from cspn_monodepth_tpu_torch.utils.tensorboard import TBWriter

__all__ = ["CSVLogger", "TBWriter", "colored_depthmap", "merge_into_row",
           "save_image"]
