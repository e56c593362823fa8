#!/usr/bin/env python3
"""Does torch's CUDA pooling backward agree with the CPU's on
channels-last input?

    python3 tools/torch_pool_channels_last_grad.py

Plain torch only, no port code.  For each pool at k3 s2 (padding 1 or 0,
both ``count_include_pad`` modes for the average pools) it feeds one
seeded float32 input to ``F.{avg,max}_pool{1,2,3}d`` three ways: on the
CPU, contiguous (the reference); on the card, contiguous; and on the
card in the layout a channels-last port input reaches the pool in (for
1-D the permuted ``[N, C, L]`` view of a contiguous ``[N, L, C]``
tensor, for 2-D / 3-D the ``channels_last`` / ``channels_last_3d``
memory format).  It prints one JSON line per case with each card run's
largest error of the output and of the input gradient (of ``Σ out ·
c``, ``c`` seeded) as a share of the reference's rms, and ``differs``
where the channels-last gradient is off by more than 1e-4 of it.

``paddle_tpu_torch/nn/functional/pooling.py`` pads channels-last
average pools explicitly and makes 1-D channels-last average-pool input
contiguous because of the cases this prints as differing; once it
prints none on the torch in use, that route can go.  The shapes are
``chip_smoke.py`` V1's pool inputs.  Exits 2 without a card.
"""
import json
import sys

SHAPES = {1: (32, 64, 1000), 2: (32, 64, 56, 57), 3: (8, 32, 14, 29, 28)}
TOL = 1e-4


def _err(got, ref):
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    return float((got - ref).abs().max()) / (
        float(ref.pow(2).mean().sqrt()) or 1.0)


def _channels_last(torch, x, n):
    if n == 1:  # the [N, C, L] view of a contiguous [N, L, C] tensor
        return x.movedim(1, -1).contiguous().movedim(-1, 1)
    fmt = torch.channels_last if n == 2 else torch.channels_last_3d
    return x.contiguous(memory_format=fmt)


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_pool_channels_last_grad: needs a CUDA card",
              file=sys.stderr)
        return 2
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    differing = []
    for n, shape in SHAPES.items():
        g = torch.Generator().manual_seed(n)
        x = torch.randn(shape, generator=g)
        cases = [("avg", p, inc) for p in (1, 0) for inc in (True, False)
                 if p or inc] + [("max", 1, None)]
        for kind, pad, inc in cases:
            fn = getattr(F, f"{kind}_pool{n}d")
            kw = {} if kind == "max" else {"count_include_pad": inc}

            def run(t):
                t = t.detach().requires_grad_(True)
                out = fn(t, 3, 2, pad, **kw)
                cot = torch.randn(out.shape, generator=torch.Generator(
                ).manual_seed(7)).to(out.device)
                (grad,) = torch.autograd.grad((out * cot).sum(), [t])
                return out, grad

            ref_out, ref_grad = run(x)
            row = {"pool": f"{kind}_pool{n}d", "padding": pad,
                   "count_include_pad": inc, "shape": list(shape)}
            for name, t in (("contiguous", x.cuda()),
                            ("channels_last", _channels_last(
                                torch, x.cuda(), n))):
                out, grad = run(t)
                row[name] = {"out_err": _err(out, ref_out),
                             "grad_err": _err(grad, ref_grad)}
            row["differs"] = row["channels_last"]["grad_err"] > TOL
            if row["differs"]:
                differing.append(f"{row['pool']} p{pad} inc={inc}")
            print(json.dumps(row), flush=True)
    print(json.dumps({"channels_last_grad_differs": differing}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
