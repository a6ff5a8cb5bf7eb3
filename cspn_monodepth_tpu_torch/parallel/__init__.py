from cspn_monodepth_tpu_torch.parallel.comm import all_reduce, all_to_all
from cspn_monodepth_tpu_torch.parallel.halo import (
    cspn_propagate_spatial,
    exchange_halo,
    gather_rows,
    scatter_rows,
)
from cspn_monodepth_tpu_torch.parallel.launch import spawn_ranks
from cspn_monodepth_tpu_torch.parallel.mesh import (
    Mesh,
    init_distributed,
    make_mesh,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "init_distributed",
    "all_reduce",
    "all_to_all",
    "exchange_halo",
    "cspn_propagate_spatial",
    "scatter_rows",
    "gather_rows",
    "spawn_ranks",
]
