from cspn_monodepth_tpu_torch.parallel.comm import (
    all_reduce,
    all_to_all,
    all_to_all_v,
)
from cspn_monodepth_tpu_torch.parallel.halo import (
    cspn_propagate_spatial,
    exchange_halo,
    gather_rows,
    scatter_rows,
)
from cspn_monodepth_tpu_torch.parallel.launch import spawn_ranks
from cspn_monodepth_tpu_torch.parallel.mesh import (
    Mesh,
    choose_layout,
    init_distributed,
    make_mesh,
)
from cspn_monodepth_tpu_torch.parallel.rows import (
    Rows,
    conv2d_rows,
    fetch_rows,
    max_pool_rows,
    row_range,
    unpool_cat_rows,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "choose_layout",
    "init_distributed",
    "all_reduce",
    "all_to_all",
    "all_to_all_v",
    "Rows",
    "row_range",
    "fetch_rows",
    "conv2d_rows",
    "max_pool_rows",
    "unpool_cat_rows",
    "exchange_halo",
    "cspn_propagate_spatial",
    "scatter_rows",
    "gather_rows",
    "spawn_ranks",
]
