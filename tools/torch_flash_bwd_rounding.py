#!/usr/bin/env python3
"""How far the bf16 flash backward kernels may sit from the plain version.

    python3 tools/torch_flash_bwd_rounding.py [--heads N] [--seed S]

The dq and dk / dv kernels (``paddle_tpu_torch/ops/csrc/
flash_attention_bwd.cu``) multiply bf16 q, k, v and dO exactly (float32
accumulators), but round ``p`` and ``ds`` to bf16 where they enter the
tensor cores; the plain version (``flash_attention_bwd_ref``) keeps them
float32.  Both round dq / dk / dv to bf16 once.  This script emulates the
kernels' rounding on the CPU in float32 (q-row chunks, as the plain version
runs) and prints, for each gradient, the largest error as a share of each
element's allowance under the rule the chip checks use,
``|err| <= rtol * |ref| + c * rms(ref row)`` (rtol 2e-2; row = the output
row over head_dim; the checks' further floor of 1e-3 of the tensor's RMS
is left out here), i.e. the smallest ``c`` that passes, at the shapes of
``chip_smoke.py`` phase LT1: its small cases and a few heads of the
slice's and bench.py's shapes.  CPU only; the inputs are seeded normal
numbers, ``dO`` too.
"""
from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RTOL = 2e-2


def emulated_backward(torch, q, k, v, lse, do, delta, causal, off, scale):
    """The kernels' arithmetic: p and ds rounded to bf16 before their
    products, float32 sums, outputs rounded to bf16."""
    B, H, S, hd = q.shape
    K = k.shape[2]
    bf = torch.bfloat16
    kf, vf = k.float(), v.float()
    lse = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    dq = torch.empty(B, H, S, hd)
    dk = torch.zeros(B, H, K, hd)
    dv = torch.zeros(B, H, K, hd)
    step = max(1, (1 << 26) // max(1, B * H * K))
    keys = torch.arange(K)
    for r0 in range(0, S, step):
        r1 = min(S, r0 + step)
        qc, doc = q[:, :, r0:r1].float(), do[:, :, r0:r1].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * scale
        if causal:
            pos = off + torch.arange(r0, r1)
            s = s.masked_fill(pos[:, None] < keys[None, :], -math.inf)
        p = torch.exp(s - lse[:, :, r0:r1, None])
        dp = torch.einsum("bhqd,bhkd->bhqk", doc, vf)
        ds = p * (dp - delta[:, :, r0:r1, None]) * scale
        p16, ds16 = p.to(bf).float(), ds.to(bf).float()
        dq[:, :, r0:r1] = torch.einsum("bhqk,bhkd->bhqd", ds16, kf)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds16, qc)
        dv += torch.einsum("bhqk,bhqd->bhkd", p16, doc)
    return dq.to(bf), dk.to(bf), dv.to(bf)


def share(torch, got, ref):
    """The smallest c with |got - ref| <= RTOL |ref| + c rms(ref row)."""
    g, r = got.float(), ref.float()
    rms = r.pow(2).mean(-1, keepdim=True).sqrt()
    over = ((g - r).abs() - RTOL * r.abs()).clamp_min(0)
    return float(torch.where(rms > 0, over / rms,
                             torch.zeros_like(over)).max())


def case(torch, fa, B, H, S, K, hd, causal, off, gen):
    q, k, v, do = (torch.randn(B, H, n, hd, generator=gen).to(torch.bfloat16)
                   for n in (S, K, K, S))
    scale = 1.0 / math.sqrt(hd)
    out, lse = fa.flash_attention_fwd_lse_ref(q, k, v, causal, scale, off)
    delta = (do.float() * out.float()).sum(-1)
    ref = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, scale,
                                     off, delta)
    emu = emulated_backward(torch, q, k, v, lse, do, delta, causal, off,
                            scale)
    return [share(torch, e, r) for e, r in zip(emu, ref)]


def main() -> int:
    import importlib

    import torch

    import chip_smoke as cs

    # the module (``paddle_tpu_torch.ops.flash_attention`` is also the
    # function the package exports)
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--heads", type=int, default=1,
                    help="heads of the slice's and bench shapes emulated")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    gen = torch.Generator().manual_seed(args.seed)
    worst = [0.0, 0.0, 0.0]
    shapes = [(2, 3, S, K, hd, causal, off)
              for hd in (64, 128, 256)
              for S, K, causal, off in cs.FLASH_BWD_CASES]
    shapes += [(1, args.heads, cs.LC_S, cs.LC_S, 64, True, 0),
               (1, args.heads, cs.BENCH_OP[2], cs.BENCH_OP[2],
                cs.BENCH_OP[3], True, 0)]
    for B, H, S, K, hd, causal, off in shapes:
        got = case(torch, fa, B, H, S, K, hd, causal, off, gen)
        worst = [max(a, b) for a, b in zip(worst, got)]
        print(f"[{B}, {H}, {S}, {hd}] K={K} causal={causal} offset={off}: "
              f"c needed dq {got[0]:.4f} dk {got[1]:.4f} dv {got[2]:.4f}",
              flush=True)
    print(f"largest c needed (rtol {RTOL}): dq {worst[0]:.4f} dk "
          f"{worst[1]:.4f} dv {worst[2]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
