#!/usr/bin/env python3
"""How well-posed is a float32 ResNet-50 training step?  (CPU, port only)

    python3 tools/torch_resnet_conditioning.py [--batch 4] [--hw 64]

Builds the port's ``resnet50(data_format="NHWC", stem_space_to_depth=True)``
from seed 0 on the CPU, draws seeded uniform(-1, 1) images and labels, and
takes the train-mode cross-entropy gradient of every parameter four ways:

* float64, plain tail (the reference);
* float32, plain tail;
* float32, the fused tail (the ``conv1x1_bn_relu`` autograd.Function over
  the kernels' plain versions, its gate forced open — the arithmetic the
  card runs, minus the kernels' summation order);
* float32, plain tail, images scaled by (1 + 1e-7).

It prints, for each float32 gradient against the float64 one and for the
perturbed against the unperturbed float32 one: the L2 distance over all
parameters relative to the reference's norm, and the worst and median
over tensors of ``max|diff| / max|reference|``.  The answer bounds what
any two float32 implementations of the step (the card and the CPU, the
port and the JAX package) can agree on after one optimizer step.  This is
a CPU measurement of numerics, not of speed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def grads(torch, images, labels, dtype, fused=False):
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fcb

    gate = fcb.fused_epilogues_eligible
    if fused:
        fcb.fused_epilogues_eligible = lambda cout, x: True
    try:
        net = ptt.vision.models.resnet50(
            data_format="NHWC", stem_space_to_depth=True, device="cpu",
            generator=torch.Generator().manual_seed(0)).to(dtype)
        net.train()
        loss = ptt.nn.CrossEntropyLoss()(net(images.to(dtype)), labels)
        loss.backward()
    finally:
        fcb.fused_epilogues_eligible = gate
    return {n: p.grad.double() for n, p in net.named_parameters()}


def compare(torch, got, ref):
    flat = lambda g: torch.cat([t.flatten() for t in g.values()])  # noqa
    per = sorted(float((got[n] - ref[n]).abs().max() / ref[n].abs().max())
                 for n in ref)
    return {"l2_rel": float((flat(got) - flat(ref)).norm()
                            / flat(ref).norm()),
            "worst_tensor": per[-1], "median_tensor": per[len(per) // 2]}


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--hw", type=int, default=64)
    args = ap.parse_args()
    rng = np.random.RandomState(10)
    images = torch.from_numpy(rng.uniform(
        -1, 1, (args.batch, args.hw, args.hw, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 1000, (args.batch, 1)).astype(
        np.int32))
    ref = grads(torch, images, labels, torch.float64)
    f32 = grads(torch, images, labels, torch.float32)
    out = {"batch": args.batch, "hw": args.hw,
           "plain_f32_vs_f64": compare(torch, f32, ref),
           "fused_f32_vs_f64": compare(
               torch, grads(torch, images, labels, torch.float32, True), ref),
           "f32_input_plus_1e-7_vs_f32": compare(
               torch, grads(torch, images * (1 + 1e-7), labels,
                            torch.float32), f32)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
