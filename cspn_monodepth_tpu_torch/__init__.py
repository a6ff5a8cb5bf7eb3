"""cspn_monodepth_tpu_torch: the PyTorch/CUDA port of cspn_monodepth_tpu.

The same depth network (ResNet UNet + CSPN refinement) and serving API as
the JAX package, for an NVIDIA Hopper GPU: plain tensor code is PyTorch,
and the CSPN propagation is a hand-written CUDA kernel (csrc/). The port
imports nothing of the JAX package; the JAX package is its reference.
"""

from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.models import CSPNDepthNet
from cspn_monodepth_tpu_torch.ops import cspn_propagate
from cspn_monodepth_tpu_torch.serving import DepthPredictor

__all__ = ["CSPNDepthNet", "DepthPredictor", "cspn_propagate", "get_config"]
