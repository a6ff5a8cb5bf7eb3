from cspn_monodepth_tpu_torch.train.loop import Trainer
from cspn_monodepth_tpu_torch.train.loss import (
    get_loss_fn,
    masked_l1_loss,
    masked_mse_loss,
)
from cspn_monodepth_tpu_torch.train.metrics import (
    AverageMeter,
    MetricSums,
    finalize_metrics,
    metric_sums_from_batch,
)
from cspn_monodepth_tpu_torch.train.train_state import (
    TrainState,
    make_lr_schedule,
    make_optimizer,
)

__all__ = [
    "Trainer",
    "TrainState",
    "make_lr_schedule",
    "make_optimizer",
    "masked_mse_loss",
    "masked_l1_loss",
    "get_loss_fn",
    "MetricSums",
    "metric_sums_from_batch",
    "finalize_metrics",
    "AverageMeter",
]
