from cspn_monodepth_tpu_torch.models.convert import (
    jax_variables,
    load_jax_variables,
)
from cspn_monodepth_tpu_torch.models.cspn_net import CSPNDepthNet
from cspn_monodepth_tpu_torch.models.resnet import ResNetEncoder
from cspn_monodepth_tpu_torch.models.torch_weights import (
    load_pretrained_encoder,
)
from cspn_monodepth_tpu_torch.models.unet import UpProjDecoder

__all__ = ["ResNetEncoder", "UpProjDecoder", "CSPNDepthNet",
           "load_jax_variables", "jax_variables", "load_pretrained_encoder"]
