"""Time of the train step's parts outside the encoder, decoder and CSPN (the
counterpart of the root tools/profile_step_parts.py), by the marginal
chain (profile_components.py's `chain_ms`):

  sampler   - uniform_sparse_sample (Philox scores + top-k over H*W)
  heads     - the f32 9-channel head conv (TF32 off)
  loss      - masked MSE
  metrics   - metric_sums_from_batch
  clip_opt  - global-norm clip + SGD-momentum update of the model's
              parameters (stand-in gradients), as TrainState applies it

    python -m cspn_monodepth_tpu_torch.tools.profile_step_parts
        [--batch 32] [--iters 10] [--hw 228x304]
        [--config nyu_completion_500]
"""

from __future__ import annotations

import json

import torch

from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.models import CSPNDepthNet
from cspn_monodepth_tpu_torch.ops.sparse import uniform_sparse_sample
from cspn_monodepth_tpu_torch.tools import device_line, parser
from cspn_monodepth_tpu_torch.tools.profile_components import chain_ms
from cspn_monodepth_tpu_torch.train.loss import masked_mse_loss
from cspn_monodepth_tpu_torch.train.metrics import metric_sums_from_batch
from cspn_monodepth_tpu_torch.train.train_state import (
    TrainState,
    make_lr_schedule,
    make_optimizer,
)


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--hw", default="228x304")
    ap.add_argument("--config", default="nyu_completion_500")
    args = ap.parse_args(argv)
    line = device_line(args.device)
    dev = args.device
    b, n = args.batch, args.iters
    h, w = (int(v) for v in args.hw.split("x"))
    cfg = get_config(args.config)
    res = {"batch": b, "hw": f"{h}x{w}", "config": args.config,
           "device": line}

    gen = torch.Generator(device=dev).manual_seed(0)
    depth = 0.1 + 9.9 * torch.rand((b, h, w), generator=gen, device=dev)

    # --- sampler: a fresh draw each step, fed back into the depth
    def samp(d):
        sp = uniform_sparse_sample(d, cfg.data.num_samples, generator=gen)
        return d + sp * 1e-9

    res["sampler_ms"] = chain_ms(samp, depth, n)

    # --- heads: the f32 head conv of the decoder's output
    model = CSPNDepthNet.from_config(cfg.model).to(dev)
    feat = torch.rand((b, model.head.in_channels, h, w), generator=gen,
                      device=dev)

    def heads(f):
        with torch.no_grad():
            return f + model.head(f)[:, :1].mean() * 1e-9

    res["heads_ms"] = chain_ms(heads, feat, n)

    # --- loss and metric sums of a prediction
    pred = (depth * 1.01)[..., None]
    target = depth[..., None]

    def loss(p):
        return p + masked_mse_loss(p, target) * 1e-12

    def metrics(p):
        sums = metric_sums_from_batch(p, target,
                                      protocol=cfg.train.metrics_protocol)
        return p + (sums.rmse + sums.n_images) * 1e-12

    with torch.no_grad():
        res["loss_ms"] = chain_ms(loss, pred, n)
        res["metrics_ms"] = chain_ms(metrics, pred, n)

    # --- clip + optimizer update at the model's scale
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(cfg.train, model))
    params = list(model.parameters())
    schedule = make_lr_schedule(cfg.train, 1)

    def update(acc):
        for p in params:
            p.grad = p.detach() * 1e-8          # stand-in gradients
        state.apply_gradients(schedule, cfg.train.clip_norm)
        return acc + params[-1].detach().reshape(-1)[0] * 0

    res["clip_opt_ms"] = chain_ms(update, torch.zeros((), device=dev), n)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
