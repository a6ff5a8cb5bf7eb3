from cspn_monodepth_tpu_torch.ops.cspn import cspn_propagate
from cspn_monodepth_tpu_torch.ops.cspn_ref import (
    NEIGHBOR_OFFSETS,
    cspn_propagate_ref,
    cspn_propagate_ref_nchw,
    normalize_affinity,
)

__all__ = [
    "NEIGHBOR_OFFSETS",
    "normalize_affinity",
    "cspn_propagate_ref",
    "cspn_propagate_ref_nchw",
    "cspn_propagate",
]
