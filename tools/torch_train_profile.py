#!/usr/bin/env python3
"""Where the device time of the port's training step goes, on one card.

    python3 tools/torch_train_profile.py \
        [--model bert|gpt|both|resnet50|gpt_long|gpt_long_train|gpt_moe|
                 wide_deep|nn_encoder|nn_encoder_recompute|bert_moe|
                 bert_int8|resnet50_int8]
        [--steps-per-execution K]
    python3 tools/torch_train_profile.py --static

Builds ``chip_smoke.py``'s training workloads — BERT-base bf16
pretraining at batch 256 x 128 with 20 masked positions and
``AdamW(1e-4, multi_precision=True)``, GPT-small f32 at batch 8 x 1024
with ``AdamW(1e-3, multi_precision=True)`` (``both``, the default), or
ResNet-50 (``bench.py``'s config 2: NHWC, space-to-depth stem, bf16, batch
128 x 224 x 224, ``Momentum(0.1, 0.9, multi_precision=True,
weight_decay=1e-4)``) — runs three warm-up ``Model.train_batch`` steps,
then for each model:

* times the step's three phases with CUDA events over ``--steps`` steps:
  forward + loss, backward, optimizer step (the parts ``train_batch``
  runs in that order);
* profiles one more ``train_batch`` under ``torch.profiler`` (CPU + CUDA
  activities) and prints the window's wall time, the device-busy share
  (summed kernel and copy time over the wall time — one stream, so no
  overlap), device time by group — the port's kernels on the path
  (``layernorm_residual``, its backward, ``softmax_cross_entropy``; for
  ResNet
  ``conv1x1_bn_stats`` with its partial-sum reduction and
  ``bn_apply_relu``), cuDNN convolutions, matrix products, attention
  softmax, the optimizer's ``_foreach`` kernels, reductions (the plain
  BatchNorm statistics among them), copies and the remaining elementwise
  kernels — and the largest kernels by name.

``gpt_long`` is the long-context inference path instead: ``gpt_small(
max_position=8192, dropout=0.0)`` in bf16 scoring 2 x 8192 tokens through
``Model.eval_batch`` (its attention through ``flash_attention``): the
mean ``eval_batch`` time over ``--steps`` calls from CUDA events, then one
``eval_batch`` under the profiler, grouped the same way.
``gpt_long_train`` is ``chip_smoke.py`` phase LT2's step: the same model
trained at 2 x 8192 with ``AdamW(1e-4, weight_decay=0.01,
multi_precision=True)``, its attention through the flash forward and the
dq and dk / dv backward kernels; phases and profile as for training.
``gpt_moe`` is ``chip_smoke.py`` phase M2's step: ``gpt_small(
moe_experts=8, moe_top_k=2, dropout=0.0)`` in bf16 at 8 x 1024 with the
same optimizer, every expert FFN through ``grouped_matmul``; besides the
groups by kernel name it prints the device time by step of the model: the
tool wraps the MoE layer's router, dispatch, expert FFN and combine and
the attention forward in ``torch.profiler.record_function`` ranges (the
model itself carries none) and charges each backward kernel to the range
of the forward op its autograd node came from (the profiler's sequence
numbers); the expert matmuls' backward (``_GroupedMatmulBackward``, the
two masked products in plain PyTorch) and AdamW are groups of their own.

``nn_encoder`` is ``chip_smoke.py`` phase N2's step: the long-document
encoder (``nn.Embedding(32768, 512)``, six ``nn.TransformerEncoderLayer(
512, 8, 2048, dropout=0.1, attn_dropout=0.0)``, ``nn.Linear(512,
32768)``) over 2 x 8192 tokens under amp O1 with ``AdamW(3e-4,
weight_decay=0.01)``, its attention through the flash forward and the dq
and dk / dv backward kernels (non-causal); ``nn_encoder_recompute`` the
same with ``nn.apply_recompute(net, ["TransformerEncoderLayer"])``
(phase N3): phases and profile as for training.

``bert_moe`` is ``chip_smoke.py`` phase E4's step:
``BertForPretraining(bert_base(moe_experts=8, moe_top_k=2))`` in bf16 at
64 x 128 (20 masked) with ``AdamW(1e-4, multi_precision=True)``, with
``gpt_moe``'s device time by model step (the attention range is
``BertSelfAttention``'s).  ``bert_int8`` and ``resnet50_int8`` are
inference: phase E5's forward (``BertForSequenceClassification(
bert_base(quantization="int8"))`` at 32 x 128) and phase C2's int8
forward (ResNet-50 NHWC bf16 at 128 x 224² after
``PostTrainingQuantization`` over 4 seeded batches): the mean of
``--steps`` synchronized forwards, then one forward under the profiler
(kernel 9 is the ``quantized_matmul`` group).

``wide_deep`` is ``chip_smoke.py`` phase S2's step: ``WideDeep`` at a
million ids (8 fields, dim 32, dense 8, MLP 64-32) with sparse tables and
``Adam(1e-3, lazy_mode=True)`` at batch 256 (numpy batches, as the ingest
hands them over).  Its step is bound by the host, so the phases are host
milliseconds around synchronized calls — the sparse gradient (the tape's
forward and backward, ``build_sparse_step``) and the optimizer step (the
tables' row rules and the dense layers' foreach Adam) — and the profile
adds the launches of the step and the ops with the most host time.

``--steps-per-execution K`` (K > 1, the training models) prepares the
model with ``steps_per_execution=K`` and drives
``Model._train_batches_device`` with K copies of the batch: the first
execution runs eagerly, the second captures the K steps as one CUDA
graph, later ones replay it.  After three executions the tool prints the
mean synchronized execution time over ``--steps`` executions (and per
step), then profiles one replayed execution: its device-busy share beside
the eager step's, the groups and kernels as above.

``--static`` profiles bench.py's configs 3 and 2 through the 1.x static
graph instead (``chip_smoke.py`` phases ST3 and ST4: the same programs,
built by ``_st_bert_program`` / ``_st_resnet_program``): an
``Executor.run_steps`` window of 10 (BERT-base) or 60 (ResNet-50) steps,
run twice to warm up (the signature's first call runs eagerly, the second
captures the CUDA graph), then the mean of ``--steps`` synchronized
replayed windows, then one replayed window under the profiler: its
device-busy share and device time by group, the port's kernels 2 and 3
(BERT) or 7 and 8 (ResNet) among them.

Numbers under the profiler run slower than ``chip_smoke.py``'s; read the
shares, not the absolute times.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("quantized_matmul", ("qmm_kernel",)),
    ("grouped_matmul", ("gmm_bf16_kernel", "gmm_bf16_wgmma_kernel",
                        "gmm_f32_kernel", "gmm_f32_small_kernel")),
    ("flash_attention", ("flash_fwd_",)),
    ("flash_attention_bwd_dq", ("flash_bwd_dq_",)),
    ("flash_attention_bwd_dkv", ("flash_bwd_dkv_",)),
    ("layernorm_residual", ("ln_res_kernel", "ln_res_wide_kernel",
                            "ln_res_vec_kernel")),
    ("layernorm_residual backward", ("ln_bwd_kernel",
                                     "ln_bwd_reduce_kernel")),
    ("softmax_cross_entropy", ("sxent_kernel",)),
    ("conv1x1_bn_stats", ("stats_bf16_kernel", "stats_bf16_wgmma_kernel",
                          "stats_f32_kernel", "reduce_partials_kernel")),
    ("bn_apply_relu", ("bn_apply_kernel", "bn_apply_resident_kernel")),
    ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit",
                             "cudnn")),
    ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "matmul")),
    ("softmax", ("softmax",)),
    ("optimizer (_foreach)", ("multi_tensor_apply", "foreach")),
    ("reduction", ("reduce_kernel",)),
    ("copy", ("memcpy", "memset")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise/other"


def build(torch, which):
    """(label, Model, inputs, labels) of one of chip_smoke's training
    workloads."""
    import numpy as np

    import chip_smoke as cs
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import (BertForPretraining,
                                         GPTForCausalLM, bert_base,
                                         gpt_small)

    ptt.seed(cs.SEED)
    if which == "bert_moe":
        net = BertForPretraining(bert_base(
            moe_experts=cs.MOE_E, moe_top_k=cs.MOE_K), device="cuda").astype(
                "bfloat16")
        opt = ptt.optimizer.AdamW(1e-4, weight_decay=0.01,
                                  multi_precision=True)
        model = ptt.Model(net, [0] * 4, [0] * 2).prepare(optimizer=opt,
                                                         loss=net.loss)
        inputs, labels = cs.bert_batch(30522, cs.BERT_MOE_B, cs.BERT_MOE_S,
                                       cs.BERT_P, seed=cs.SEED + 93)
        return (f"bert_base moe {cs.MOE_E} experts top-{cs.MOE_K} bf16 "
                f"{cs.BERT_MOE_B}x{cs.BERT_MOE_S}", model, inputs, labels)
    if which in ("nn_encoder", "nn_encoder_recompute"):
        net = cs._long_doc_encoder(torch)
        if which == "nn_encoder_recompute":
            ptt.nn.apply_recompute(net, ["TransformerEncoderLayer"])
        model = ptt.Model(net).prepare(
            optimizer=ptt.optimizer.AdamW(cs.NN_LR, weight_decay=0.01),
            loss=net.loss, amp_configs="O1")
        ids, labels = cs._nn_batch()
        return (f"{which} amp O1 {cs.NN_B}x{cs.NN_S}", model, [ids],
                [labels])
    if which == "wide_deep":
        from paddle_tpu_torch.models import WideDeep

        net = WideDeep(num_fields=cs.S2_FIELDS, vocab_size=cs.CTR_VOCAB,
                       embed_dim=cs.S2_EMBED, dense_dim=cs.S2_DENSE,
                       hidden_sizes=cs.S2_HIDDEN, sparse=True)
        model = ptt.Model(net, inputs=["sparse", "dense"],
                          labels=["label"])
        model.prepare(optimizer=ptt.optimizer.Adam(1e-3, lazy_mode=True),
                      loss=net.loss)
        rng = np.random.RandomState(cs.SEED + 400)
        table = rng.randn(cs.CTR_VOCAB)
        w_dense = rng.randn(cs.S2_DENSE) * 0.5
        ids, xd, y = cs._ctr_clicks(np, cs.S2_B, rng, table, w_dense,
                                    cs.S2_FIELDS, cs.S2_DENSE)
        return (f"wide_deep 1M x {cs.S2_EMBED} sparse lazy-Adam "
                f"batch {cs.S2_B}", model, [ids, xd], [y])
    if which == "gpt_moe":
        net = cs.moe_model(torch, "bfloat16")
        opt = ptt.optimizer.AdamW(1e-4, weight_decay=0.01,
                                  multi_precision=True)
        model = ptt.Model(net).prepare(optimizer=opt, loss=net.loss)
        ids = np.random.RandomState(cs.SEED + 41).randint(
            0, 50304, size=(cs.MOE_B, cs.MOE_S)).astype(np.int32)
        return (f"gpt_small moe {cs.MOE_E} experts top-{cs.MOE_K} bf16 train "
                f"{cs.MOE_B}x{cs.MOE_S}", model, [ids], [ids])
    if which == "gpt_long_train":
        net = cs.long_context_model(torch, "bfloat16")
        opt = ptt.optimizer.AdamW(1e-4, weight_decay=0.01,
                                  multi_precision=True)
        model = ptt.Model(net).prepare(optimizer=opt, loss=net.loss)
        ids = np.random.RandomState(cs.SEED + 31).randint(
            0, 50304, size=(cs.LC_B, cs.LC_S)).astype(np.int32)
        return (f"gpt_small bf16 train {cs.LC_B}x{cs.LC_S}", model, [ids],
                [ids])
    if which == "gpt_long":
        net = cs.long_context_model(torch, "bfloat16")
        model = ptt.Model(net).prepare(loss=net.loss)
        ids = np.random.RandomState(cs.SEED + 21).randint(
            0, 50304, size=(cs.LC_B, cs.LC_S)).astype(np.int32)
        return (f"gpt_small bf16 eval {cs.LC_B}x{cs.LC_S}", model, [ids],
                [ids])
    if which == "resnet50":
        net = cs.resnet_model(torch, "bfloat16", "cuda")
        model = cs.resnet_trainer(torch, net)
        rng = np.random.RandomState(cs.SEED)
        images = torch.from_numpy(rng.uniform(
            -1, 1, (cs.RESNET_B, cs.RESNET_HW, cs.RESNET_HW, 3)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        labels = torch.from_numpy(rng.randint(
            0, 1000, (cs.RESNET_B, 1)).astype(np.int32)).to("cuda")
        return (f"resnet50 bf16 NHWC {cs.RESNET_B}x{cs.RESNET_HW}x"
                f"{cs.RESNET_HW}", model, [images], [labels])
    if which == "bert":
        net = BertForPretraining(bert_base(), device="cuda").astype(
            "bfloat16")
        opt = ptt.optimizer.AdamW(1e-4, weight_decay=0.01,
                                  multi_precision=True)
        model = ptt.Model(net, [0] * 4, [0] * 2).prepare(optimizer=opt,
                                                         loss=net.loss)
        inputs, labels = cs.bert_batch(30522, cs.BERT_B, cs.BERT_S,
                                       cs.BERT_P)
        return (f"bert_base bf16 {cs.BERT_B}x{cs.BERT_S}", model, inputs,
                labels)
    net = GPTForCausalLM(gpt_small(), device="cuda")
    opt = ptt.optimizer.AdamW(1e-3, weight_decay=0.01, multi_precision=True)
    model = ptt.Model(net).prepare(optimizer=opt, loss=net.loss)
    ids = np.random.RandomState(cs.SEED).randint(
        0, 50304, size=(cs.GPT_B, cs.GPT_S)).astype(np.int32)
    return f"gpt_small f32 {cs.GPT_B}x{cs.GPT_S}", model, [ids], [ids]


def build_inference(torch, which):
    """(label, run) of phase E5's int8 BERT forward or phase C2's int8
    ResNet-50 forward: ``run(inputs, labels)`` is one forward without
    gradient."""
    import chip_smoke as cs
    from paddle_tpu_torch import slim
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         bert_base)
    from paddle_tpu_torch.vision.models import resnet50

    if which == "bert_int8":
        import numpy as np

        net = BertForSequenceClassification(
            bert_base(quantization="int8"), device="cuda",
            generator=torch.Generator().manual_seed(cs.SEED + 95)).eval()
        rng = np.random.RandomState(cs.SEED + 96)
        x = [torch.from_numpy(a).to("cuda") for a in (
            rng.randint(0, 30522, size=(cs.QBERT_B, cs.BERT_S)),
            (rng.uniform(size=(cs.QBERT_B, cs.BERT_S)) < 0.5).astype(
                np.int64), np.ones((cs.QBERT_B, cs.BERT_S), np.int64))]
        label = f"bert_base int8 forward {cs.QBERT_B}x{cs.BERT_S}"
    else:
        net = resnet50(data_format="NHWC", device="cuda",
                       generator=torch.Generator().manual_seed(cs.SEED)
                       ).astype("bfloat16").eval()
        gen = torch.Generator(device="cuda")

        def images(seed):
            gen.manual_seed(seed)
            return (torch.rand(cs.C2_B, cs.C2_HW, cs.C2_HW, 3,
                               device="cuda", generator=gen) * 2 - 1).to(
                torch.bfloat16)

        ptq = slim.PostTrainingQuantization(net)
        for i in range(cs.C2_CALIB):
            ptq.collect(images(cs.SEED + 100 + i))
        net = ptq.quantize()
        x = [images(cs.SEED + 98)]
        label = f"resnet50 int8 (PTQ) forward {cs.C2_B}x{cs.C2_HW}²"

    def run(_inputs=None, _labels=None):
        with torch.no_grad():
            return net(*x)

    run.__name__ = "forward"
    return label, run


def phases(torch, model, inputs, labels, steps):
    """Mean ms of forward+loss, backward and optimizer step from CUDA
    events, in ``train_batch``'s order."""
    batch = model._batch(inputs, labels)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    tot = [0.0, 0.0, 0.0]
    model.network.train()
    for _ in range(steps):
        ev[0].record()
        loss = model._forward_loss(batch)[0]
        ev[1].record()
        loss.backward()
        ev[2].record()
        model._optimizer.step()
        model._optimizer.clear_grad()
        ev[3].record()
        torch.cuda.synchronize()
        for i in range(3):
            tot[i] += ev[i].elapsed_time(ev[i + 1])
    return [t / steps for t in tot]


def sparse_phases(torch, model, inputs, labels, steps):
    """Mean host ms, each part synchronized, of the sparse step's batch
    staging, gradient (``build_sparse_step``) and optimizer step."""
    from paddle_tpu_torch.framework.selected_rows import build_sparse_step

    tot = [0.0, 0.0, 0.0]
    model.network.train()
    params = dict(model.network.named_parameters())
    shapes = {n: tuple(params[n].shape) for n in model._sparse.values()}
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = model._batch(inputs, labels)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fl = lambda _p: (model._forward_loss(batch)[0], None)
        _, grads = build_sparse_step(fl, model._sparse, shapes)(params)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        model._optimizer.step(grads)
        model._optimizer.clear_grad()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for i, (a, b) in enumerate(((t0, t1), (t1, t2), (t2, t3))):
            tot[i] += (b - a) * 1e3
    return [t / steps for t in tot]


def eval_ms(torch, model, inputs, labels, steps):
    """Mean ms of ``eval_batch`` from CUDA events."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(steps):
        model.eval_batch(inputs, labels)
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / steps


#: the tool's record_function ranges over the MoE model's steps
RANGES = (("MoELayer", "_route", "moe: router"),
          ("MoELayer", "_dispatch", "moe: dispatch (one-hot products)"),
          ("MoELayer", "_expert_ffn", "moe: expert FFN (bias, GELU)"),
          ("MoELayer", "_combine", "moe: combine (one-hot product)"),
          ("ParallelAttention", "forward", "attention"),
          ("BertSelfAttention", "forward", "attention"))
_BWD = "autograd::engine::evaluate_function: "


def execution_ms(torch, run, inputs, labels, steps):
    """The mean wall ms of ``steps`` synchronized calls of ``run``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run(inputs, labels)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def label_ranges():
    """Wrap each of RANGES in a ``record_function`` of its label."""
    from torch.profiler import record_function

    from paddle_tpu_torch.models.bert import BertSelfAttention
    from paddle_tpu_torch.models.gpt import ParallelAttention
    from paddle_tpu_torch.moe import MoELayer

    owners = {"MoELayer": MoELayer, "ParallelAttention": ParallelAttention,
              "BertSelfAttention": BertSelfAttention}
    for owner, name, label in RANGES:
        cls = owners[owner]
        fn = getattr(cls, name)

        def wrapped(*a, _fn=fn, _label=label, **k):
            with record_function(_label):
                return _fn(*a, **k)

        setattr(cls, name, wrapped)


def by_range(events):
    """Device ms by model step: each kernel goes to the innermost labelled
    range around the op that launched it; a backward kernel to its
    autograd node's forward range (by sequence number), ``grouped_matmul``
    backward and AdamW to groups of their own, the port's kernels to
    their names; the rest to "other"."""
    labels = {label for _, _, label in RANGES}

    def chain(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    seq_label = {}
    for e in events:
        if getattr(e, "sequence_nr", -1) >= 0 and not e.name.startswith(
                _BWD):
            lab = next((a.name for a in chain(e) if a.name in labels), None)
            if lab is not None:
                seq_label.setdefault(e.sequence_nr, lab)
    out = {}
    for e in events:
        for k in e.kernels:
            if k.name in labels:  # the range itself on the device timeline
                continue
            group = _group(k.name)
            if group in ("elementwise/other", "matmul", "softmax",
                         "reduction", "copy"):
                group = "other"
                for a in chain(e):
                    if a.name in labels:
                        group = a.name
                        break
                    if a.name.startswith(_BWD):
                        if "_GroupedMatmulBackward" in a.name:
                            group = "grouped_matmul backward (masked products)"
                        elif a.sequence_nr in seq_label:
                            group = seq_label[a.sequence_nr] + " backward"
                        break
            g = out.setdefault(group, [0.0, 0])
            g[0] += k.duration
            g[1] += 1
    return out


def profile_step(torch, run, inputs, labels, ranges=False):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(inputs, labels)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ranges_on_device = {label for _, _, label in RANGES}
    rows = []
    for e in prof.key_averages():
        if ("CUDA" not in str(e.device_type)
                or e.key in ranges_on_device):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((float(us), e.count, e.key))
    rows.sort(reverse=True)
    host_ops = sorted(((float(e.self_cpu_time_total), e.count, e.key)
                       for e in prof.key_averages()), reverse=True)
    return (wall_us, rows, by_range(prof.events()) if ranges else None,
            host_ops)


def build_static(torch, which):
    """(label, run, steps) of ``chip_smoke.py`` ST3's (``bert``) or ST4's
    (``resnet50``) program: ``run()`` is one ``run_steps`` window."""
    import chip_smoke as cs
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import bert_base

    paddle.seed(0)
    if which == "bert":
        cfg = bert_base()
        _, main, startup, loss = cs._st_bert_program(
            torch, cfg, cs.BERT_B, cs.BERT_S, cs.BERT_P)
        feeds = cs._st_bert_feeds(cfg, cs.BERT_B, cs.BERT_S, cs.BERT_P)
        n, const = cs.ST_BERT_STEPS, tuple(feeds)
        label = "static bert_base bf16 (bench.py config 3)"
    else:
        _, main, startup, loss, feeds = cs._st_resnet_program(
            torch, cs.RESNET_B)
        n, const = cs.ST_RESNET_STEPS, ("image", "label")
        label = "static resnet50 bf16 (bench.py config 2)"
    exe = fluid.Executor()
    exe.run(startup)

    def run(_inputs=None, _labels=None):
        return exe.run_steps(main, feed=feeds, fetch_list=[loss],
                             iterations=n, fetch_every=n,
                             constant_feeds=const)

    run.__name__ = f"replayed run_steps window of {n} steps"
    return label, run, n


def print_profile(gpu, label, run_name, wall_us, rows):
    busy = sum(r[0] for r in rows)
    print(f"profile[{gpu}] {label}: one {run_name} under the profiler "
          f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms = "
          f"{100 * busy / wall_us:.1f}% of it")
    groups = {}
    for us, n, name in rows:
        g = groups.setdefault(_group(name), [0.0, 0])
        g[0] += us
        g[1] += n
    for g, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"profile[{gpu}] {label}: {g:22s} {us / 1e3:9.2f} ms "
              f"device ({100 * us / busy:5.1f}% of busy), {n} launches")
    for us, n, name in rows[:15]:
        print(f"profile:   {us / 1e3:9.3f} ms  x{n:<6d} {name[:110]}")
    return busy


def main_static(torch, gpu, steps) -> int:
    for which in ("bert", "resnet50"):
        label, run, n = build_static(torch, which)
        for _ in range(2):  # the eager window, then the capture
            run()
        ms = execution_ms(torch, run, None, None, steps)
        print(f"phases[{gpu}] {label}: window {ms:.2f} ms = {ms / n:.3f} "
              f"ms a step (one CUDA graph replay), mean of {steps} "
              f"synchronized windows")
        wall_us, rows, _, _ = profile_step(torch, run, None, None)
        print_profile(gpu, label, run.__name__, wall_us, rows)
        del run
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("bert", "gpt", "both", "resnet50",
                                        "gpt_long", "gpt_long_train",
                                        "gpt_moe", "wide_deep", "nn_encoder",
                                        "nn_encoder_recompute", "bert_moe",
                                        "bert_int8", "resnet50_int8"),
                    default="both")
    ap.add_argument("--steps", type=int, default=5,
                    help="steps averaged by the phase timing")
    ap.add_argument("--steps-per-execution", type=int, default=1,
                    help="k > 1: time and profile executions of k steps "
                         "(each after the second a CUDA graph replay)")
    ap.add_argument("--static", action="store_true",
                    help="profile chip_smoke.py ST3's and ST4's replayed "
                         "run_steps windows (bench.py configs 3 and 2)")
    args = ap.parse_args()
    k = args.steps_per_execution
    if k > 1 and args.model in ("gpt_long", "bert_int8", "resnet50_int8"):
        ap.error("--steps-per-execution needs a training model")
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA card visible", file=sys.stderr)
        return 2
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = cs.gpu_line()
    if args.static:
        return main_static(torch, gpu, args.steps)
    if args.model in ("bert_int8", "resnet50_int8"):
        label, run = build_inference(torch, args.model)
        for _ in range(3):
            run()
        ms = execution_ms(torch, run, None, None, args.steps)
        print(f"phases[{gpu}] {label}: forward {ms:.2f} ms, mean of "
              f"{args.steps} synchronized forwards")
        wall_us, rows, _, _ = profile_step(torch, run, None, None)
        print_profile(gpu, label, run.__name__, wall_us, rows)
        return 0
    for which in (("bert", "gpt") if args.model == "both"
                  else (args.model,)):
        label, model, inputs, labels = build(torch, which)
        run = (model.eval_batch if which == "gpt_long"
               else model.train_batch)
        if k > 1:
            model.prepare(optimizer=model._optimizer, loss=model._loss,
                          steps_per_execution=k)
            batch = tuple(inputs) + tuple(labels)

            def run(_inputs, _labels, _batch=batch):
                return model._train_batches_device([_batch] * k)
            run.__name__ = f"execution of {k} steps"
            label = f"{label} steps_per_execution={k}"
        for _ in range(3):
            run(inputs, labels)
        if k > 1:
            ms = execution_ms(torch, run, inputs, labels, args.steps)
            print(f"phases[{gpu}] {label}: execution {ms:.2f} ms = "
                  f"{ms / k:.3f} ms a step (one CUDA graph replay), mean "
                  f"of {args.steps} synchronized executions")
        elif which == "gpt_long":
            ms = eval_ms(torch, model, inputs, labels, args.steps)
            print(f"phases[{gpu}] {label}: eval_batch {ms:.2f} ms, mean of "
                  f"{args.steps} calls")
        elif which == "wide_deep":
            stage, grad, opt = sparse_phases(torch, model, inputs, labels,
                                             args.steps)
            step = stage + grad + opt
            print(f"phases[{gpu}] {label}: host step {step:.3f} ms = batch "
                  f"to the card {stage:.3f} + sparse gradient {grad:.3f} + "
                  f"optimizer {opt:.3f} (each synchronized), mean of "
                  f"{args.steps} steps")
        else:
            fwd, bwd, opt = phases(torch, model, inputs, labels, args.steps)
            step = fwd + bwd + opt
            print(f"phases[{gpu}] {label}: step {step:.2f} ms = "
                  f"forward+loss {fwd:.2f} ({100 * fwd / step:.1f}%) + "
                  f"backward {bwd:.2f} ({100 * bwd / step:.1f}%) + "
                  f"optimizer {opt:.2f} ({100 * opt / step:.1f}%), mean "
                  f"of {args.steps} steps")
        moe = which in ("gpt_moe", "bert_moe")
        if moe:
            label_ranges()
        wall_us, rows, steps, host_ops = profile_step(
            torch, run, inputs, labels, ranges=moe)
        busy = print_profile(gpu, label, run.__name__, wall_us, rows)
        for g, (us, n) in sorted((steps or {}).items(),
                                 key=lambda kv: -kv[1][0]):
            print(f"profile[{gpu}] {label}: by step: {g:42s} "
                  f"{us / 1e3:9.2f} ms device ({100 * us / busy:5.1f}% of "
                  f"busy), {n} launches")
        if which == "wide_deep":
            launches = sum(n for _, n, _ in rows)
            print(f"profile[{gpu}] {label}: {launches} device kernels and "
                  f"copies in the step; host ops by self CPU time:")
            for us, n, name in host_ops[:15]:
                print(f"profile:   host {us / 1e3:8.3f} ms  x{n:<5d} "
                      f"{name[:100]}")
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
