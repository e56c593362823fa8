#!/usr/bin/env python3
"""Phases of ``chip_smoke.py`` run from the tree in the current directory,
for an A/B of two whole trees in one call on the card::

    git archive <commit> | tar -x -C chip_scratch/parent   # a gitignored dir
    for t in parent . . parent; do
        (cd $t && python3 /path/to/repo/tools/torch_serve_train_ab.py \\
            [serve] [bert] [long] [layernorm] [resnet])
    done

``serve``: phase 4 (gpt_small paged serving); ``bert``: phase 7
(BERT-base bf16 ``train_batch``); ``long``: phase LT2 (the long-context
training step); ``layernorm``: ``layernorm_residual``'s forward and
backward timed at phase 10's shapes and phase W's (``time_ln``: device
time by CUDA graph, past the L2, beside the plain versions, the library
calls and the bounds); ``resnet``: phases R3 (ResNet-50 bf16 eager
``train_batch``) and K3 (the same through ``fit(steps_per_execution=4)``).
No phase named: ``serve bert``.

Builds the kernels the phases run (into the tree's own ``ops/_build/``),
runs the phases with their gates, and prints one line ``AB <tree>
{...}`` after the phases' own lines: ``tokens_per_s`` / ``mean_ms``,
``bert_step_ms``, ``long_step_ms``, ``layernorm`` (``{shape:
[forward ms, backward ms]}``), ``resnet_step_ms`` and
``resnet_fit_step_ms`` for the phases run.  Exits non-zero
without a card or on an unknown phase.
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())

#: the kernel sources each phase builds
SOURCES = {"serve": ("paged_attention", "fused_layernorm",
                     "fused_softmax_xent"),
           "bert": ("fused_layernorm", "fused_softmax_xent"),
           "long": ("flash_attention", "flash_attention_bwd",
                    "fused_layernorm", "fused_softmax_xent"),
           "layernorm": ("fused_layernorm",),
           "resnet": ("fused_conv1x1_bn",)}


def main() -> int:
    import torch

    phases = sys.argv[1:] or ["serve", "bert"]
    if not torch.cuda.is_available() or not set(phases) <= set(SOURCES):
        print("torch_serve_train_ab: needs a CUDA card; phases: "
              f"{' '.join(SOURCES)}", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build

    _build.build(*sorted({s for p in phases for s in SOURCES[p]}))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = cs.gpu_line()
    out = {}
    if "serve" in phases:
        model = cs.build_serve_model(torch)
        served = cs.serve(torch, gpu, model)
        del model
        out.update(tokens_per_s=served["tokens_per_s"],
                   mean_ms=served["mean_ms"])
    if "bert" in phases:
        out["bert_step_ms"] = cs.train_bert(torch, gpu)["step_ms"]
        torch.cuda.empty_cache()
    if "long" in phases:
        out["long_step_ms"] = cs.long_context_training(torch, gpu)["step_ms"]
        torch.cuda.empty_cache()
    if "layernorm" in phases:
        from paddle_tpu_torch.ops import fused_layernorm as fl

        shapes = [(dtype, M, D, has) for _, dtype, M, D, has
                  in cs.LN_SHAPES] + [(dtype, *cs.WIDE_LN, True)
                                      for dtype in ("float32", "bfloat16")]
        gen = torch.Generator().manual_seed(cs.SEED + 4)
        ln = {}
        with torch.no_grad():
            for dtype, M, D, has_ds in shapes:
                row = cs.time_ln(torch, fl, gpu, dtype, M, D, has_ds, gen)
                ln[f"{dtype} [{M}, {D}]"] = [row["ms"],
                                             row["backward"]["ms"]]
                torch.cuda.empty_cache()
        out["layernorm"] = ln
    if "resnet" in phases:
        eager = cs.train_resnet(torch, gpu)
        torch.cuda.empty_cache()
        out.update(resnet_step_ms=eager["step_ms"],
                   resnet_fit_step_ms=cs.resnet_graph(
                       torch, gpu, eager)["step_ms"])
        torch.cuda.empty_cache()
    print("AB", os.path.basename(os.getcwd()), json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
