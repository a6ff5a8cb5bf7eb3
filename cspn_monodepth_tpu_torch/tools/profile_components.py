"""Time of each component of the model by the marginal chain: encoder,
decoder, CSPN and the whole model, forward and (--train) forward +
backward (the counterpart of the root tools/profile_components.py).

Each component is timed as utils/profiling.py `marginal_chain` times a
step: chains of N and 5N serially dependent calls, the step (t_5N - t_N)
/ 4N, the host's launches included. The forward chains run in eval mode
without a gradient; a train probe takes the gradient of a mean square of
the component's output with respect to its parameters and moves them by
1e-9 of it, in train mode (BatchNorm on batch statistics). The model is
`--config`'s at its full width, bf16 encoder and decoder as configured,
seeded weights.

    python -m cspn_monodepth_tpu_torch.tools.profile_components
        [--batch 32] [--hw 228x304] [--iters 10] [--num-iters 24] [--train]
        [--config nyu_completion_500]
"""

from __future__ import annotations

import dataclasses
import json

import torch

from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.models import CSPNDepthNet
from cspn_monodepth_tpu_torch.ops import cspn_propagate
from cspn_monodepth_tpu_torch.tools import device_line, parser
from cspn_monodepth_tpu_torch.utils.profiling import marginal_chain


def chain_ms(fn, carry, n: int) -> float:
    """Marginal ms of one `carry -> carry` call."""
    step, _ = marginal_chain(lambda c, _: fn(c), carry, n=n)
    return step * 1e3


def nudge(params, loss) -> torch.Tensor:
    """The gradient of loss with respect to params, params moved by 1e-9
    of it in place; a scalar that waits for the update."""
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        torch._foreach_add_(params, grads, alpha=-1e-9)
    return loss.detach() * 1e-12 + params[-1].detach().reshape(-1)[0] * 0


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--hw", default="228x304")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--num-iters", type=int, default=24)
    ap.add_argument("--train", action="store_true",
                    help="also time forward + backward of each component")
    ap.add_argument("--config", default="nyu_completion_500")
    args = ap.parse_args(argv)
    line = device_line(args.device)
    dev = args.device
    h, w = (int(v) for v in args.hw.split("x"))
    b, n = args.batch, args.iters

    model = CSPNDepthNet.from_config(dataclasses.replace(
        get_config(args.config).model, num_iters=args.num_iters)
    ).to(dev).eval()
    enc, dec = model.encoder, model.decoder
    bf16 = model.dtype == torch.bfloat16

    def autocast():
        return torch.autocast(torch.device(dev).type, dtype=torch.bfloat16,
                              enabled=bf16)

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((b, 4, h, w), generator=gen, device=dev)
    guid = torch.randn((b, 8, h, w), generator=gen, device=dev)
    blur = torch.rand((b, h, w), generator=gen, device=dev)
    sp = blur * (torch.rand(blur.shape, generator=gen, device=dev) < 0.01)
    with torch.no_grad(), autocast():
        skips = tuple(enc(x))

    def cspn(d):
        return cspn_propagate(guid, d, sp, num_iters=args.num_iters,
                              norm_type="8sum_clamp",
                              guidance_layout="NCHW")

    res = {}
    with torch.no_grad():
        def enc_step(xx):
            with autocast():
                return xx + enc(xx)[-1].float().mean() * 1e-9

        def dec_step(sk):
            with autocast():
                bump = dec(sk, (h, w)).float().mean() * 1e-9
            return tuple(s + bump.to(s.dtype) for s in sk)

        def full_step(xx):
            return xx + model(xx).mean() * 1e-9

        res["encoder_fwd_ms"] = chain_ms(enc_step, x, n)
        res["decoder_fwd_ms"] = chain_ms(dec_step, skips, n)
        res[f"cspn{args.num_iters}_fwd_ms"] = chain_ms(cspn, blur, n)
        res["full_fwd_ms"] = chain_ms(
            full_step, x.permute(0, 2, 3, 1).contiguous(), n)

    if args.train:
        model.train()
        enc_p, dec_p = list(enc.parameters()), list(dec.parameters())
        full_p = list(model.parameters())

        def enc_train(acc):
            with autocast():
                loss = sum(s.float().pow(2).mean() for s in enc(x))
            return acc + nudge(enc_p, loss)

        def dec_train(acc):
            with autocast():
                loss = dec(skips, (h, w)).float().pow(2).mean()
            return acc + nudge(dec_p, loss)

        def cspn_train(d):
            d = d.detach().requires_grad_()
            g, = torch.autograd.grad(cspn(d).pow(2).mean(), d)
            return d.detach() - 1e-9 * g

        def full_train(acc):
            xx = x.permute(0, 2, 3, 1)
            return acc + nudge(full_p, model(xx).pow(2).mean())

        zero = torch.zeros((), device=dev)
        res["encoder_fwdbwd_ms"] = chain_ms(enc_train, zero, n)
        res["decoder_fwdbwd_ms"] = chain_ms(dec_train, zero, n)
        res[f"cspn{args.num_iters}_fwdbwd_ms"] = chain_ms(cspn_train, blur,
                                                          n)
        res["full_fwdbwd_ms"] = chain_ms(full_train, zero, n)

    res.update(batch=b, hw=f"{h}x{w}", config=args.config, device=line)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
