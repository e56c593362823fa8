#!/usr/bin/env python3
"""On-card smoke of the PyTorch/H100 port (``paddle_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, in order — any failure raises and exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off for
   matmul and cuDNN, so float32 means float32;
2. build: every CUDA source of the port with ``nvcc`` for ``sm_90a`` (one
   process per source, started together), with the build seconds and the
   assembler's register/shared-memory report;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card at the serving shapes (f32 and bf16, ragged tables, unmapped
   entries, fully-masked rows), and the paged kernel's split design at its
   edges (a slot with no valid page, one whose split holds shares with no
   valid key; two calls bit-equal);
4. serve: ``GPTForCausalLM(gpt_small())`` at full GPT-2-small width with
   seeded random weights behind ``GenerationEngine(paged=True)`` — 16
   requests, two sharing a prefix; the kernel launch counts are zeroed just
   before and read just after, and must equal ``num_layers x (admission
   calls + decode steps)``; tokens of 4 requests are held against the
   port's uncached greedy ``forward`` on the card (a disagreement must be a
   near-tie, top-1 margin < 1e-4);
5. timing: kernel / plain / library-call milliseconds at the decode shapes
   from CUDA events, beside the bandwidth/compute bound, engine tokens/s,
   mean request latency and peak device memory; the paged kernel's and the
   gather + SDPA yardstick's device time from a CUDA graph (their eager
   calls, which Python bounds, beside them);
6. train kernels vs plain: ``layernorm_residual`` and
   ``softmax_cross_entropy`` against their plain versions at the training
   path's shapes (BERT-base bf16, GPT-small f32; ``layernorm_residual``
   also at the long-context slice's [16384, 768] bf16,
   ``softmax_cross_entropy`` also at BERT-base's float32 [5120, 30522]
   logits under amp O1, phase F2's): ``s`` exactly
   equal, ``y`` / loss / ``lse`` and the gradients through each
   ``autograd.Function`` within stated tolerances; ``layernorm_residual``'s
   forward in the design its plan picks and in its first design, its
   backward kernel with and without the s cotangent in the design its plan
   picks and in its element layout, against ``_backward_ref``: ds within
   the forward's tolerance, dg / db within it after scaling by their
   largest magnitude, two calls bit-equal;
7. BERT-base pretraining, the training main path:
   ``BertForPretraining(bert_base())`` in bf16 with
   ``AdamW(1e-4, weight_decay=0.01, multi_precision=True)`` through
   ``Model.train_batch`` at batch 256 x seq 128 with 20 masked positions
   (seeded data built as ``bench.py`` builds it), 3 warm-up and 10 timed
   steps on one batch; the counts are zeroed just before the timed steps
   and must equal 24 x steps (``layernorm_residual``, forward and
   backward) and 1 x steps (``softmax_cross_entropy``); losses finite and
   falling, master slots float32; seq/s and peak device memory;
8. GPT-small training: ``GPTForCausalLM(gpt_small())`` f32, dropout 0.1,
   ``AdamW(1e-3, weight_decay=0.01, multi_precision=True)`` at batch 8 x
   seq 1024, 2 warm-up and 3 timed steps; counts 12 x steps (forward and
   backward) and 1 x steps; tokens/s;
9. card vs CPU: ``bert_base()`` f32 with dropout 0 from one seeded init,
   two ``train_batch`` steps on the card (kernels) and on the CPU (plain
   versions); losses agree at rtol 1e-4;
10. timing of both training kernels at their shapes: kernel, plain
    version and library call (``F.layer_norm(x + r)``,
    ``F.cross_entropy(reduction="none")``) beside the bytes bound;
    ``layernorm_residual``'s forward and backward by CUDA graph (device
    time, the eager call beside it, the first forward design, the plain
    versions and the library calls — the backward's
    ``native_layer_norm_backward``, plus the s cotangent's add where the
    path has one — by the same method, inputs rotated past the L2).

Quantized serving (run between phases 5 and 6, on the model of phase 4):

Q1. ``quantized_matmul`` kernel vs plain at the path's four ``(K, N)``
    pairs and M in {8, 40, 384}, int8 and fp8: the int8 accumulator
    (scale 1, bias 0) and the int8 output bit-equal; fp8 within rtol 1e-4 /
    atol 1e-4 x max|out| (float32 sums in another order), each fp8
    shape's error printed as its share of that tolerance;
Q2. ``paged_flash_decode`` over int8 and fp8 pools with their scale planes
    vs the plain version at T = 1, 5, 16, 48, geometry as phase 3, and the
    split design's edges as phase 3's at T = 1 and 5;
Q3. the phase-4 requests through ``GenerationEngine(quantized="int8")`` and
    again ``"fp8"``, over the SAME float model (checked bit-identical
    afterwards): every request completes, ``quantized_linear.launches`` =
    4 x layers x (admission calls + decode steps) and
    ``paged_flash_decode.launches`` = layers x the same, the pool is
    int8 / float8_e4m3fn with float32 scale planes; agreement with the
    float model's teacher-forced top-1 is reported with the margin rule of
    ``tools/quant_smoke.py`` (tau = 4 x the largest quantized-vs-float
    logit difference; a flip at a margin above tau fails the run);
Q4. timing: both kernels, their plain versions and the library calls
    (``torch._int_mm`` where M > 16, ``torch._scaled_mm``; gather +
    dequantize + ``scaled_dot_product_attention``) beside the bound (the
    paged kernel and its yardstick timed as in phase 5), and
    the float / int8 / fp8 engines side by side; ``quantized_matmul`` at
    all four linears x M in {8, 40, 384} x both modes, its time and the
    library's the device time of a CUDA graph of the calls (the eager
    call, bounded by its Python, beside it), with the achieved GB/s and
    TOP/s.

The default serving engines, the hand-off and weight swaps (after Q4, on
the model of phase 4 where it serves):

D1. ``GenerationEngine(model, prompt_buckets=[16, 48], batch_size=8)``
    with default flags — dense-ring continuous batching — on phase 4's
    requests: every request completes, no kernel of ``ops/`` launches
    (the dense float path has none), 4 requests' tokens against uncached
    greedy (near-ties only, as phase 4); tokens/s, mean / p99 latency,
    peak device memory, the ring's bytes, and the device-busy share of a
    second pass under ``torch.profiler``;
D2. the same with ``continuous=False`` (the legacy scheduler): tokens
    equal D1's (a difference must be a near-tie of uncached greedy);
D3. ``bench.py``'s ``bench_gpt_generate`` with ``paddle_tpu_torch`` for
    ``paddle_tpu``: its ``GPTConfig`` (vocab 8192, hidden 256, 4 layers, 8
    heads, max_position 512), ``RequestTrace.synthetic()`` replayed through
    the legacy, continuous and paged engines at ``max_queue_delay_ms=1.0``;
    a line under bench.py's names; the paged run's kernel-1 launches; the
    trace's tokens of legacy and paged against continuous (near-ties
    only);
D4. prefill/decode hand-off at phase 4's shape, float and int8
    (``speculative_k=0``, phase 4's first ``D4_REQUESTS`` requests, one at
    a time): tokens bit-identical to
    a co-located paged engine, kernel 1 (and 9) launches counted on the
    prefill and the decode engine against their calls, payload bytes and
    ms per export / import;
D5. hot swaps at ``gpt_small`` width: an ``export_quantized`` int8 artifact
    into a quantized dense engine (kernel 9's launches there counted) and
    a float side-file into a float dense engine; outputs equal an engine
    built over the donor; seconds a swap.
A ``{"serving_engines": ...}`` line carries D1-D5's numbers; the kernels
line's kernel 1 and 9 entries gain their launches there.

ResNet-50 training, ``bench.py``'s config 2 (after phase 10):

R1. ``conv1x1_bn_stats`` and ``bn_apply_relu`` against their plain
    versions in both designs of each: the Hopper designs (kernel 7 on the
    TMA ring with wgmma, w K-major as ResNet passes it and MN-major, the two
    bit-equal; kernel 8 with resident scales) at the four conv3 shapes of
    ResNet-50 at batch 128 (bf16) and at 1000 x 64 x 136 (M and N off the
    tiles), the first designs at the same conv3 shapes (forced), layer3's
    in float32 and ragged M, K, N (where the wrappers pick them): y within
    a bf16 ulp (f32: rtol 1e-5), the column sums within 3e-5 x sum|y|, two
    runs bit-equal; ``bn_apply_relu`` bit-equal with and without the
    residual; each line names the design that served it;
R2. the fused tail's ``autograd.Function`` against autograd of its plain
    version at layer3's shape, float32 (1e-4) and bf16 (2e-2 of each
    tensor's largest entry): output, running mean and variance, dx, dw,
    dgamma, dbeta, dresidual;
R3. ``resnet50(data_format="NHWC", stem_space_to_depth=True)`` in bf16
    with ``Momentum(0.1, 0.9, multi_precision=True, weight_decay=1e-4)``
    and cross entropy on float32 logits through ``Model.train_batch`` at
    batch 128 x 224 x 224 (seeded uniform(-1, 1) images, labels in
    [0, 1000)), 3 warm-up and 10 timed steps; the counts are zeroed just
    before the timed steps and must equal 16 x steps for each kernel;
    losses finite; every bn3 buffer moved and is still bf16; img/s,
    ms/step, peak device memory;
R4. card vs CPU: ResNet-50 float32 at 64 x 64, batch 4, one seeded model
    bridged to the card, 3 ``train_batch`` steps each (the card through
    the fused tail, 16 launches a step; the CPU through the plain tail);
    the step-1 loss at rtol 1e-4 and the step-1 parameter update within
    10% (L2) — the float32 gradient of this network at initialization is
    too ill-conditioned for the later losses to agree at 1e-4 between any
    two float32 implementations (see the phase's docstring);
R5. timing of both kernels at the four conv3 shapes: the Hopper design,
    the first design, the plain version and ``torch.mm`` (the product
    alone), median (min-max) of 3 runs, beside the bound; the designs' and
    ``torch.mm``'s device time from a CUDA graph of the calls (the eager
    call, which the wrapper's Python bounds at layers 3-4, beside it).

Long-context GPT inference (after R5):

L1. ``flash_attention`` (kernel 4) against its plain version at head_dim
    64, 128 and 256, float32 and bf16, causal and not, ragged S and K,
    K > S, a non-aligned and a negative ``q_position_offset`` (rows with
    no valid key exactly 0 / lse -inf), S = 127 and 129 against the bf16
    kernel's 128-row q tile: out within rtol 1e-5 / atol 2e-5
    (float32) or, bf16 (P is rounded to bf16 for the P.V product), within
    2e-2 of the element plus 2e-2 of its reference row's RMS; lse within
    1e-5 (float32) / 1e-3 (bf16); then at the slice's shape;
L2. ``GPTForCausalLM(gpt_small(max_position=8192, dropout=0.0))`` in bf16
    (12 layers x 12 heads, head_dim 64, seeded random weights) through
    ``Model.eval_batch`` (twice) and ``predict_batch`` (once) at batch 2 x
    8192; the counts are zeroed just before and must equal 12 x forwards
    (``flash_attention``, ``layernorm_residual``) and 1 x eval_batch
    (``softmax_cross_entropy``); the loss finite, the logits finite and
    ``[2, 8192, 50304]`` bf16; tokens/s and peak device memory, then the
    same model with the flash gate closed (the dense einsum): its peak
    memory must be the larger, its loss within 1e-2;
L3. card vs CPU: a 2-layer gpt_small-width model in float32 at 1 x 4096,
    one seeded init; the card through the kernel (2 launches a forward),
    the CPU through the dense path; eval_batch losses at rtol 1e-4,
    predict_batch logits within rtol 1e-4 / atol 1e-4;
L4. timing, bf16 causal, at the slice's shape and at bench.py's op shape
    (B 1, H 8, S 32768, hd 128): kernel, plain version and
    ``F.scaled_dot_product_attention`` from CUDA events, median (min-max)
    of 3 runs, beside the bound (the causal pairs' operations at 989
    TFLOP/s);
W.  the width repairs: ``layernorm_residual`` at the hidden-1024 GPT's
    shape [2048, 1024], float32 and bf16, held and timed as phases 6 and
    10 hold and time the narrow shapes (the Hopper design, and the first
    design's wide variant; the backward with the s cotangent);
    ``gpt_small(hidden_size=1024, num_heads=16)`` takes one
    ``train_batch`` (12 forward and 12 backward launches);
    ``paged_flash_decode`` at head_dim 320 and at page 1024 (staged in row
    chunks), each over float32 and bf16 q and float, int8 and fp8 pools,
    against its plain version.

Long-context GPT training (after W):

LT1. the flash backward kernels (dq, kernel 5; dk / dv, kernel 6) through
     ``flash_attention_bwd_chunk`` against the plain backward at head_dim
     64, 128 and 256, float32 and bf16, S = K and S != K ragged, causal and
     not, offsets 0, 37, K - S and -64 (keyless rows: dq exactly 0), S =
     127 and 129 against the bf16 kernels' 128-row blocks: dq,
     dk, dv within rtol |ref| + row_rms rms(ref row) + tensor_rms rms(ref)
     (``FLASH_BWD_TOL``: bf16 2e-2 / 2e-2 / 1e-3, float32 1e-4 each); then
     bf16 causal at the slice's shape and at bench.py's op shape, two runs
     bit-equal; then a ring step over two kv chunks whose partials sum to
     the full gradient;
LT2. the slice model in bf16 with ``AdamW(1e-4, weight_decay=0.01,
     multi_precision=True)`` through ``Model.train_batch`` at 2 x 8192, the
     same seeded batch, 2 warm-up and 5 timed steps; the counts are zeroed
     just before the timed steps and must equal 12 x steps
     (``flash_attention``, ``flash_attention_bwd_dq``,
     ``flash_attention_bwd_dkv``, ``layernorm_residual`` forward and
     backward) and 1 x steps
     (``softmax_cross_entropy``); losses finite and falling, f32 master
     slots; tokens/s, ms/step, peak device memory; then the same model at
     1 x 8192 through the flash route and with the gate closed (the dense
     einsum): step time and peak memory, the flash peak the smaller;
LT3. card vs CPU: a 2-layer gpt_small-width model in float32 at 1 x 4096,
     one seeded init, two ``train_batch`` steps each (the card through
     kernels 4-6, the CPU through the dense path): both losses at rtol
     1e-4, every parameter's step-1 gradient within 1e-4 of its L2 norm;
LT4. timing, bf16 causal, at the slice's and bench.py's op shapes and at
     [1, 8, 8192, 256]: each
     backward kernel beside its bound (6 and 8 flops a causal pair a head
     dim at 989 TFLOP/s), the port's backward call, the plain backward and
     the library's (``F.scaled_dot_product_attention`` backward through
     ``torch.autograd.grad``), median (min-max) of 3 runs; the port's
     forward + backward of bench.py's op beside the library's.

MoE GPT training and paged serving (after LT4):

M1. ``grouped_matmul`` (kernel 10) against its plain version: the slice's
    fc1 ``[8, 2560, 768] x [8, 768, 3072]`` and fc2 ``[8, 2560, 3072] x
    [8, 3072, 768]`` in bf16 with the group sizes of a real routing (a
    gpt_small-width ``MoELayer`` routing 8192 seeded rows) and with 0, C,
    > C, negative and non-tile-multiple sizes, and the 128-row tile's edges
    (0, 1, 127, 128, 129, C - 1, C); float32 at the serving shapes (C = 16
    and 80); the JAX test's ragged shape (E 3, C 80, D 16, F 160, gs [80,
    37, 0]) and one with D not a multiple of 8, both dtypes, and one with F
    not a multiple of 8 in bf16 (the first design's instance; each line
    names the design that served it).  Padding rows hold NaN and must come out exactly 0; two
    launches bit-equal; every element within ``GMM_TOL`` (float32 1e-5
    |ref| + 1e-5 rms(ref); bf16 one bf16 step, 2^-7 |ref| + 1e-3
    rms(ref)); a wrong shape raises;
M2. the slice, ``GPTForCausalLM(gpt_small(moe_experts=8, moe_top_k=2,
    dropout=0.0))`` in bf16 (every MLP an 8-expert top-2 ``MoELayer``,
    capacity factor 1.25, jitter 0.01, balance weight 0.01) with
    ``AdamW(1e-4, weight_decay=0.01, multi_precision=True)`` through
    ``Model.train_batch`` at 8 x 1024 tokens, 2 warm-up and 5 timed steps;
    the counts are zeroed just before the timed steps and must equal 24 x
    steps (``grouped_matmul``), 12 x steps (``layernorm_residual``,
    forward and backward) and steps (``softmax_cross_entropy``); losses
    finite and falling; the aux
    loss finite and printed; every expert's float32 master moved; bf16
    parameters equal to their masters rounded; ms/step, tokens/s, peak
    device memory and the overflow fraction after the last step;
M3. card vs CPU: a 2-layer float32 MoE (hidden 256, FFN 1024, 8 experts,
    top-2, capacity factor 1.25, jitter 0) at 2 x 512, one seeded init,
    two ``train_batch`` steps each (the card through the kernel, the CPU
    through the masked einsum): step-1 routing identical (a differing
    decision must be a near-tie, margin < 1e-5, and is printed), both
    losses at rtol 1e-4, every step-1 gradient within 1e-4 of its L2 norm;
M4. MoE paged serving: the same model in float32 with capacity factor 8
    (= E: no token is ever dropped) behind ``GenerationEngine(paged=True)``
    with phase 4's 16 requests: every request completes,
    ``paged_flash_decode`` launches as in phase 4, ``grouped_matmul``
    launches = 24 x (admission calls + decode steps), tokens of 4
    requests equal the uncached greedy except near-ties, no dropped token,
    ``moe_routed_tokens`` = layers x top_k x batch x the step widths of
    the decode steps; tokens/s, mean / p99 latency and peak memory beside
    the dense float engine of phase 4;
M5. timing of kernel 10 at M1's slice shapes (bf16) and at the decode
    shapes (float32, a real routing of 8 and 40 rows: T = 1 and 5) from
    CUDA events over two input copies, median (min-max) of 3 runs, beside
    the plain version, ``torch.bmm`` over the full buffers (the library's
    product alone) and the bound (2 sum(gs) D F operations at the dtype's
    peak, or the valid x rows, the weights of experts with rows, the whole
    output at 3.35 TB/s).

The training loop under amp (after M5):

F1. ``layernorm_residual`` at the mixed dtypes amp hands it, BERT-base's
    [32768, 768]: (bf16, f32, f32) and (bf16, bf16, f32) — what O1 gives
    layer 1's first LayerNorm and the other 23 — and (f16, f32, f32),
    (f16, f16, f32) (x, residual, weight / bias): both forward designs (s
    exact, y within phase 6's tolerance of x's dtype — float16's 2e-3,
    which y rounded through bf16 must fail — two calls bit-equal), both
    backward layouts with and without the s cotangent (ds within it, dg /
    db in the weight's dtype and scaled, two calls bit-equal); each mix
    timed by CUDA graph past the L2 beside the plain versions, the bytes
    bound with each operand at its own width, and ``F.layer_norm(x + r)``
    on the same dtypes where torch takes them;
F2. the slice's main path: ``BertForPretraining(bert_base())`` with
    float32 parameters and dropout 0.1, ``Model.prepare(AdamW(1e-4,
    weight_decay=0.01), net.loss, amp_configs="O1")``, ``fit`` over 4
    seeded batches of 256 x 128 (20 masked; built as ``bench.py`` builds
    them) for 2 epochs, shuffled, evaluating on a fifth batch after each,
    with ``ModelCheckpoint`` and ``LRScheduler``; the counts are zeroed
    when epoch 2 begins and read when fit ends: ``layernorm_residual`` 24
    x (4 + 1) forward and 24 x 4 backward, ``softmax_cross_entropy`` 4 +
    1; losses finite, epoch 2's mean below epoch 1's; the checkpoint files
    present; the final checkpoint loaded into a fresh model and optimizer
    on the card evaluates to the trained model's loss bit for bit;
    ``predict``'s MLM logits float32 [32, 20, 30522]; seq/s of fit's
    second epoch beside ``train_batch`` over the same batches, save / load
    seconds, checkpoint size, peak device memory;
F3. card vs CPU under O1: ``bert_base()`` f32 with dropout 0 from one
    seeded init on each; the first 4 x 128 batch's gradient through the
    model's O1 forward and loss, by its relative L2 difference over all
    parameters and over kernel 2's 24 LayerNorms (``FIT_PARITY_GRAD_RTOL``),
    then two ``fit`` steps unshuffled, the losses at ``FIT_PARITY_RTOL``
    (bf16 products round in other places on the two; both limits a few
    times the card's readings);
F4. a custom float16 loop: BERT-base under ``auto_cast(dtype="float16")``
    with ``GradScaler`` for 4 steps (kernel 2 in float16, 24 launches a
    step each way); step 3 gets an inf gradient: skipped (parameters and
    the optimizer's count unchanged) and the loss scale halves.

Sparse CTR training (after F4; no kernel of ``ops/`` is on this path — in
the JAX package it is plain XLA — so the kernels record does not change):

S1. the sparse rules on the card against the same rules on the CPU: a
    1,000,000 x 32 float32 table (``Embedding(sparse=True, padding_idx=0)``
    under a ``Linear(32, 1)``), one batch of 2048 ids (256 x 8) that
    repeats hot ids and holds the padding id, one ``train_batch`` step of
    SGD, Momentum, Adagrad, Ftrl, Adam lazy, Adam non-lazy (densified),
    AdamW lazy with decay, Lamb (densified), Adam lazy under
    ``ClipGradByGlobalNorm``, and Adam lazy with ``multi_precision`` on a
    bf16 table, each from one CPU-drawn init: touched rows at rtol 1e-6 /
    atol 1e-6 of the CPU's (the bf16 table's master at lr x 2^-7, its rows'
    gradients being bf16), the dense layer at 1e-5; the padding row and,
    but for Lamb, every untouched row bit-unchanged (row mode: their slots
    too); two card runs bit-equal; the global-norm clip's norm over the
    repeated ids equal to the merged rows' (the dense scatter's, in
    float64) and not the unmerged stack's;
S2. the slice's main path: ``WideDeep(num_fields=8, vocab_size=1_000_000,
    embed_dim=32, dense_dim=8, hidden_sizes=(64, 32), sparse=True)``
    (``examples/sparse_ctr_training.py``'s model) with ``Adam(1e-3,
    lazy_mode=True)`` through ``Model.train_batch``, fed by
    ``io.InMemoryDataset`` (the native ingest, built with ``g++`` here)
    from 8 seeded text files of 51,200 rows — 8 id slots in [0, 1M), 8
    dense features and a Bernoulli click from ``bench.py:367-372``'s latent
    logit on slot 0 and the dense features — loaded by 8 threads,
    ``global_shuffle``, ``batch_iter(256)``, 200 steps: losses finite and
    the last 50's mean below the first 50's, every never-drawn row of both
    tables bit-equal to its init, held-out probabilities in (0, 1); the
    load seconds, the median step, samples/s and peak device memory;
S3. ``bench.py``'s config 5: ``wide_deep_tiny(sparse=True)``, ``Adam(1e-2,
    lazy_mode=True)``, 120 steps on 4096 rows: held-out AUC >= 0.8
    (``CTR_AUC_GATE``); the CPU from the same init: the first 10 losses at
    rtol 1e-4, the AUC within 0.01;
S4. ``tools/bench_sparse_embedding.py``'s net (dim 64, batch 256 x 4, Adam
    0.01) at vocab 1e5, 1e6 and 1e7: the sparse + lazy step's max / min
    time < 2.0 (the tool's rule); the dense path's times and every run's
    peak device memory beside them.  A ``{"sparse_ctr": ...}`` line
    carries S2's and S4's numbers.
K1. ``steps_per_execution``: each model built twice from one seed, graph
    (k = 4, every execution after the first one CUDA graph replay)
    against eager (k = 1) over 3 executions: a bf16 MLP under
    ``AdamW(multi_precision=True)`` with kernel 3 as its loss, ``WideDeep``
    at 20,000 ids with lazy Adam (the sparse branch; its replay under
    CUDA's sync check), ``Lookahead(k=5)``, ``GradientMergeOptimizer(
    k_steps=3)``, an MLP with dropout 0.1: parameters, buffers and
    optimizer state bit-equal (else within 1e-6 relative, printed), the
    launch counts equal, 12 distinct dropout masks over 3 executions;
K2. the main path of the k-step slice: S2's configuration through
    ``Model.fit(steps_per_execution=8)`` over S2's rows (``InMemoryDataset``
    into an ``io.TensorDataset``, batch 256, 25 executions): S2's gates;
    step ms (median execution 3-25 / 8), samples/s, host ms per execution
    and peak memory beside S2's;
K3. bench.py config 2 (R3's ResNet-50) through ``fit(steps_per_execution=
    4)``, 3 executions: kernels 7 and 8 16 a step each per replay, losses
    finite, bn3 buffers moved; step ms beside R3's;
K4. phase 7's BERT-base bf16 through ``fit(steps_per_execution=4)``, 3
    executions: kernel 2 24 + 24 and kernel 3 1 a step per replay, losses
    finite; step ms beside phase 7's;
K5. ``examples/train_resnet_nhwc.py`` line for line in the port (resnet18
    NHWC bf16, k = 4, 3 epochs): losses finite, callbacks once an
    execution;
T1. every name of the tensor API on the card against the CPU
    (``tools/torch_tensor_cases.py``), creation without a device on
    ``cuda:0``.  A ``{"steps_per_execution": ...}`` line carries K1-K5's
    and T1's numbers; the kernels line's entries of kernels 2, 3, 7 and 8
    carry ``graph_launches`` (one replayed execution's).

Batched multi-LoRA and multi-tenant serving (after T1; kernel 10 on both
low-rank hops of every adapted linear, two launches a site a call):

A1. ``grouped_matmul`` against ``grouped_matmul_ref`` at every hop shape
    the A phases run (``lora_hop_shapes``: rank 8 as the output width and
    as the inner width, caps 1 / 4 / 16, N = 8 / 40 / 128 / 384,
    gpt_small's and bench.py's 4 x 256 widths) with random ids, float32;
    all rows dead and all rows in one group at gpt_small's decode and
    admission shapes; bf16 cases of both hops; padding rows NaN in and 0
    out, two launches bit-equal, ``GMM_TOL``.  Every shape A2-A5 hand the
    kernel is recorded (``lora_path_shapes``) and must be one A1 held (one
    it did not list is held after the phase);
A2. ``gpt_small(lora_capacity=16, lora_rank=8)`` f32 with a seeded adapter
    in slot 0: a [4, 32] batch's logits under ids 0 against the
    dense-merged model (``merge_adapter``; ``LORA_MERGE_TOL`` x max|ref|,
    the adapter moving them by more than 10x that), ids -1 bitwise the
    unscoped model, a mixed batch's base rows bitwise; kernel 10 96
    launches a forward;
A3. the paged engine at phase 4's settings over that model with 16
    adapters installed: 34 requests round-robin over the base and the 16
    slots, all in flight (kernel 10 96 and kernel 1 12 launches a call),
    every request's tokens bit-identical to the same engine serving it
    alone, 8 requests against uncached greedy of the merged model
    (near-ties only), hot installs and a removal with 16 requests in
    flight (no error; the removed slot then serves the base tokens);
A4. a ``TenantScheduler`` (gold weight 2, free, a metered tenant with a
    50-token budget refilled at 500/s) on that model: the metered request,
    preempted mid-decode by an emptied budget, regenerates its uncontended
    tokens bit for bit beside the weighted tenants' requests (= serial),
    ``tenant_preempted`` >= 1, no page leaked; the dense-ring and legacy
    engines with adapters give the tokens they give one request at a time
    (kernel 10 96 a call, kernel 1 none); an int8 LoRA engine at batch 1
    runs kernels 9, 10 and 1 (48, 96 and 12 a call);
A5. ``bench.py``'s ``bench_gpt_generate_multilora`` in the port: its
    ``GPTConfig`` at caps 0, 1, 4 and 16 after ``paddle_tpu_torch.seed(
    1234)``, its engine (buckets 16 / 48, batch 8, ``max_queue_delay_ms=
    1.0``, continuous, paged) with ``random_adapter(..., rank=8, seed=100 +
    s)`` installed, ``RequestTrace.synthetic()`` round-robin over the
    slots, ``A_PASSES`` passes a cap: tokens/s and the worst tenant's p99
    as the median and range of the passes, kernel 10 32 and kernel 1 4
    launches a call, the 16-adapter engine's tokens bit-identical to the
    same engine serving each request alone, its busy share under
    ``torch.profiler``, ``adapter_gather_ms`` (``lora_delta`` at [8, 256],
    16 slots, CUDA events) beside ``base_matmul_ms``; a line under
    bench.py's names.  Then kernel 10 timed at the LoRA hops' decode and
    admission shapes (CUDA graph) beside its plain version, ``torch.bmm``
    and the bound.  A ``{"multilora": ...}`` line carries A1-A5; the
    kernels line's kernel-10 entry gains ``lora_launches``,
    ``lora_path_checks`` and ``lora_shapes``.

bench.py's configs 1-3 through the 1.x static graph (after T1, before
A1; ``fluid.Program`` / ``program_guard`` / ``fluid.data`` /
``layer_op`` / ``record_call`` / ``minimize`` / ``Executor``, written
with the port's API line for line):

ST1. config 1 (``bench_mnist``) exactly: the 784-128-64-10 MLP, 150 SGD
     steps in one ``run_steps`` over 4096 synthetic rows (the signature's
     first call, so eager), ``clone(for_test=True)`` on 2048: accuracy >=
     ``MNIST_ACC_GATE`` (0.97), one dispatch for the chain;
ST2. ``examples/static_graph_1x.py`` on ``Executor(CUDAPlace(0))``: 60
     ``exe.run`` steps of its convnet with ``AdamOptimizer``; the loss
     falls, the BatchNorm statistics move, a test clone leaves them;
ST3. config 3 (``bench_bert``) exactly: BERT-base bf16 at 256 x 128, 20
     masked, ``AdamW(multi_precision=True)``, ``run_steps(iterations=10,
     fetch_every=10, constant_feeds=all)``: an eager window, a capture
     window, 3 timed windows of one graph replay each (the counts zeroed
     around each: kernel 2 240 + 240, kernel 3 10), final losses finite
     and falling, float32 masters; then at dropout 0 a replayed window
     against 10 ``exe.run`` steps from the same state, both under
     ``torch.use_deterministic_algorithms`` (the embedding backward of a
     table of few rows accumulates in a run-dependent order otherwise):
     parameters, last loss and every optimizer-state tensor bit-equal;
ST4. config 2 (``bench_resnet50``) exactly: ResNet-50 NHWC s2d bf16 at
     128 x 224 x 224, ``Momentum(multi_precision=True)``,
     ``run_steps(iterations=60)`` windows as ST3's (kernels 7 and 8 960
     each a window), every BatchNorm buffer moved;
ST5. a ``{"static_graph": ...}`` line under bench.py's names
     (``mnist_mlp_smoke_accuracy``, ``bert_base_train_seq_per_sec_per_chip``,
     ``resnet50_train_img_per_sec_per_chip``): the median and range of
     the timed windows, bench.py's best window, ``achieved_tflops`` at its
     84.5 / 12.3 GFLOP an item, the MFU against the H100's dense bf16 989
     TFLOP/s, and ``Model.train_batch``'s (phases 7, R3) and
     ``fit(steps_per_execution=4)``'s (K4, K3) step times beside.  The
     kernels line's entries of kernels 2, 3, 7 and 8 carry
     ``static_launches`` (one replayed window's).

The layer library (after A5; ``nn`` / ``nn.functional`` as a user builds
models with them):

N1. kernels 4, 5 and 6 non-causal at the long-document encoder's shape
    ``[2, 8, 8192, 64]`` bf16 (q, k, v as ``MultiHeadAttention`` hands
    them: strided views of ``[B, S, H, hd]``) and at ``[2, 4, 384, 64]``
    float32 against their plain versions; timed by CUDA graph (median and
    range of 3) beside the eager call, the plain versions and
    ``F.scaled_dot_product_attention(is_causal=False)``'s forward and
    backward, with each kernel's bound over all S x K pairs;
N2. the long-document encoder (``Embedding(32768, 512)``,
    ``TransformerEncoder(TransformerEncoderLayer(512, 8, 2048,
    dropout=0.1, attn_dropout=0.0), 6)``: Transformer-base's encoder,
    ``Linear(512, 32768)``, cross-entropy) over 2 x 8192 tokens under amp
    O1 with AdamW through ``Model.train_batch``: 2 + 5 steps, losses
    finite and falling, kernels 4, 5 and 6 6 launches a step each; step
    time, tokens/s and peak memory;
N3. the same model with ``apply_recompute(net,
    ["TransformerEncoderLayer"])`` under
    ``torch.use_deterministic_algorithms``, dropout active: one step's
    loss and every gradient bit-equal to the step without recompute from
    the same parameters and seed, kernel 4 12 launches a step (forward and
    recomputation), 5 and 6 6 each, peak memory below; then
    ``fit(steps_per_execution=2)`` (3 executions: a CUDA graph replayed
    from the second) bit-equal to 6 eager ``fit`` steps;
N4. ``nn.Transformer()`` at its defaults on a synthetic copy task (vocab
    32768, 64 x 64 source and target tokens, ragged key-padding masks and
    ``generate_square_subsequent_mask``) through ``train_batch``: the
    loss falls and no flash kernel launches (the masks keep the dense
    route); then a greedy decode of 16 tokens through the decoder layers'
    caches, held to the uncached causal forward's argmax (a mismatch only
    at a near-tie);
N5. the medium LSTM language model of Zaremba et al. 2014 (2 x 650, vocab
    10000, 35 steps, batch 20, dropout 0.5) with ``SGD(1.0,
    grad_clip=ClipGradByGlobalNorm(5.0))`` over a seeded synthetic stream:
    the loss falls, the step time; a bidirectional 2-layer LSTM and a GRU
    with ragged ``sequence_length`` card vs CPU from the same weights;
N6. the JAX test's GRU seq2seq (``tests/test_decode.py``) trained on its
    copy task on the card, beam 3 accuracy > 0.9; then at H 512, vocab
    32768, batch 64, beam 4, ``max_step_num`` 32 from seeded weights: ids,
    parents and lengths on the card equal to the CPU's, scores within
    1e-5;
N7. a ``{"nn": ...}`` line with N1-N6's numbers; the kernels line's
    entries of kernels 4-6 gain ``nn_launches`` (N2's, N3's step and
    graph) and ``noncausal`` (N1's errors and times).

MoE and quantization wherever the JAX package runs them (after N7):

E1. M4's model (``gpt_small(moe_experts=8, moe_top_k=2,
    moe_capacity_factor=8.0, moe_jitter=0.0)``, float32) behind the
    default dense-ring engine (``prompt_buckets=[16, 48]``, batch 8) over
    phase 4's requests, then the legacy scheduler: every request
    completes, ``grouped_matmul`` 24 launches a call (admissions / batches
    and decode steps), no kernel 1, no routed count from the warm-up,
    ``moe_routed_tokens`` = layers x top_k x batch x decode steps (the
    ring's inert rows route too), no dropped token; 4 requests' tokens
    against uncached greedy (near-ties only), the legacy tokens against
    the continuous ones; tokens/s, latency and peak beside D1's and M4's;
E2. the same model at capacity factor 1.25: routed + dropped = layers x
    top_k x batch x decode steps; tokens/s, overflow fraction, dead
    experts (no token gate: capacity drops change tokens);
E3. E1's model quantized, int8 and fp8, behind the paged engine (phase
    4's settings) and the dense engine: kernel 9 24 launches a call (qkv
    and out: the experts stay float), kernel 10 24, kernel 1 12 a paged
    call; the margin rule of Q3, and the teacher-forced logits of the
    quantized copy, routed by the float model's decisions, within 0.1
    (int8) / 0.25 (fp8) x max|logit| of the float model's (routed freely,
    the rows where quantization flipped a routing decision are counted and
    the error printed);
E4. ``BertForPretraining(bert_base(moe_experts=8, moe_top_k=2))`` in bf16
    with ``AdamW(multi_precision=True)`` through ``train_batch`` at
    bench.py config 3's shape cut to 64 x 128 (20 masked), 2 + 5 steps:
    kernel 10 24 launches a step, kernel 2 24 forward and 24 backward,
    kernel 3 one; losses finite and falling; seq/s, ms a step, peak and
    the overflow fraction after the last step;
E5. ``BertForSequenceClassification(bert_base(quantization=mode))`` in
    eval through ``Model.predict_batch`` at 32 x 128, int8 and fp8: kernel
    9 48 and kernel 2 24 launches a forward, logits within E3's tolerance
    of the float model from the same seed; at 2 x 128 every quantized
    linear on the card against its CPU copy on the same input (int8
    bit-equal, fp8 rtol 1e-4), the logits card vs CPU within E3's
    tolerance; ms a forward, seq/s;
C1. kernel 9 on caller-quantized int8 codes (the int8 layers' route) at
    BERT's four linears at M = 4096, ResNet-50's im2col products (the 7 x
    7 stem, a 3 x 3 of each stage) and MobileNetV2's stem, pointwise
    layers and classifier: bit-equal to the plain version, timed by CUDA
    graph beside the eager call, the plain version, ``torch._int_mm``
    (where it takes the shape) and the bound;
C2. ``resnet50(data_format="NHWC")`` in bf16, eval, 128 x 224², through
    ``PostTrainingQuantization`` over 4 seeded calibration batches and
    ``quantize()``: 53 ``Int8Conv2D`` + 1 ``Int8Linear``, kernel 9 54
    launches a forward, logits within 0.1 (relative L2) of the float
    model's; at 2 x 128² every int8 layer on the card bit-equal to its CPU
    copy on the same input, the logits card vs CPU within 0.1; img/s of
    the int8 and the float forward, peak;
C3. ``mobilenet_v2()`` in float32 under ``ImperativeQuantAware()``
    (abs-max weights, moving-average activations) with ``Momentum(0.01,
    0.9)`` through ``train_batch`` at 64 x 224², 2 + 5 steps: losses
    finite, all 53 activation observers' ``_state`` at the value 7
    updates give; ``convert()``: 36 layers through kernel 9, the 17
    depthwise ones through the exact grouped route; the int8 logits
    within 0.35 (relative L2) of the fake-quant eval's; on 2 images every
    int8 layer on the card bit-equal to its CPU copy on the same input, the
    logits card vs CPU within 0.1; img/s of the QAT step and the int8
    forward.
Every shape E1-E5 and C2-C3 hand kernels 9 and 10 is recorded and held to
the plain version.  A ``{"compression": ...}`` line carries E1-C3's
numbers; the kernels line's entries of kernels 9 and 10 gain
``compression_launches`` and ``compression_path_checks`` (kernel 9 also
C1's rows under ``compression_shapes``).

The vision slice (after C3):

V1. every convolution and pool of the slice on the card against its copy
    on the CPU, float32 (TF32 off), on one seeded input: DCGAN's generator
    at batch 128 (``Conv2DTranspose`` 100 → 512 k4 s1, then k4 s2 p1 512
    → 256 → 128 → 64 → 3, 4² → 64², with and without ``output_size``,
    and cropped), C3D's ``Conv3D(64 → 128, k3, p1)`` on [8, 64, 16, 56,
    56] with ``MaxPool3D(2, return_mask=True)``, ``Conv1D`` /
    ``Conv1DTranspose`` at [32, 256, 1024], the convolutions in their
    channels-last layouts, every average and max pool in both layouts at
    ``ceil_mode`` and ``exclusive`` True and False, the adaptive pools
    (the max pools' masks None, as JAX's): output and the gradients of
    ``Σ out · c`` for the input and every parameter within 2e-3 of the
    CPU result's rms, masks equal (unique window maxima: seeded
    permutations);
V2. ResNet-50 (NHWC, space-to-depth stem, bf16, 10 classes) with
    Momentum(0.1, 0.9, multi_precision, wd 1e-4) through ``Model.fit``
    from 512 seeded 256² uint8 ``.npy`` files in 10 class folders
    (written under ``$TMPDIR``, removed after): ``DatasetFolder(loader=
    numpy.load)``, ``RandomCrop(224)`` / ``RandomHorizontalFlip`` /
    ``ToTensor("HWC")`` / ``Normalize``, ``DataLoader(batch_size=128,
    shuffle, drop_last, num_workers=8)``; one warm-up ``train_batch``,
    one epoch (4 steps): losses finite, kernels 7 and 8 16 launches each
    step; img/s end to end beside ``train_batch``'s on a batch on the
    card (no PIL anywhere on the path);
V3. V2's network saved with ``paddle_tpu_torch.save`` and rebuilt with
    ``resnet50(pretrained=path)``: eval logits bit for bit;
V4. a ``fluid.Program`` of ``conv2d_transpose``, ``conv3d``,
    ``conv3d_transpose``, ``pool2d(pool_type="avg")`` and ``pool3d``
    through ``Executor.run`` on the card against the eager layers with
    the program's parameters (1e-5 of the rms).
A ``{"vision": ...}`` line carries V1-V4's numbers; kernels 7 and 8's
entries in the kernels line gain ``vision_launches`` (V2, per step).

Then the detection slice, after V4 (``detection_phases``):

B1. every new detection op on the card against the port's CPU result on
    one seeded float32 input, forward and (where JAX differentiates)
    backward, within 1e-4 of the CPU result's rms, indices equal:
    SSD300's priors over its six maps (8732) and ``ssd_loss`` (8 x 8732
    x 21, G = 20); YOLOv3-608's ``yolov3_loss`` at [8, 255, 19 / 38 /
    76] (80 classes, the published anchors and masks) and ``yolo_box``;
    ``roi_align`` / ``roi_pool`` / ``psroi_pool`` at B2's C4 map with R =
    1024 (the CPU reference on 128 of them, then forward and backward on
    those 128 on both); ``deform_conv2d`` v1 / v2 at [2, 512, 50, 84],
    3 x 3; the RoI extras, ``matrix_nms`` and ``locality_aware_nms``
    small; then the greedy-sweep kernel against its plain loop on the
    same IoU matrix (``nms`` at k = 12000 with eta 1 and 0.9,
    ``multiclass_nms`` at 80 classes x 1000): every decision equal, or
    whose largest IoU with a kept box lies within 1e-5 of the threshold
    the loop held then; its time beside the loop's and a bytes bound;
B2. Faster R-CNN R50-C4 at ``faster_rcnn_r50_1x``'s settings, 2 x 800 x
    1344, seeded weights and boxes, Momentum(0.9, multi_precision, wd
    1e-4) at the config's lr 0.01 for 8 images scaled to 2 in its linear
    warm-up; its departures (RoI Align's sampling_ratio 0 taken as JAX's
    fixed 2, BN trained on batch statistics where the config freezes it,
    random weights) named in ``B_CONFIG``: one warm-up and 3 timed steps
    with CUDA events around each stage, losses finite and no timed step's
    total above 1.25 x the warm-up's, kernels 7 and 8 16 launches a step
    each and the sweep 1; then a ``use_random=False`` step whose RPN
    targets, proposals, sampled RoIs, labels and targets equal the CPU
    route on the same tensors, and whose 16 + 16 calls of kernels 7 and 8
    equal their plain versions on the inputs they got (R1's tolerances);
B3. inference in eval mode on a fresh detector (6000 / 1000 proposals,
    ``box_coder`` decode, ``multiclass_nms(0.05, 0.5, 100)``): ms an
    image, the detections equal to the CPU route;
B4. ``multi_box_head`` (SSD300's six maps), ``deformable_conv``,
    ``fluid.layers.roi_align`` and ``multiclass_nms`` in a Program through
    ``Executor.run`` on the card, against the eager ops and
    ``vision.ops.MultiBoxHead`` with the program's parameters.
A ``{"detection": ...}`` line carries B1-B4's numbers; kernels 7 and 8
gain ``detection_launches`` (B2, per step) and ``detection_path_checks``
(B2's check step, by shape), and the kernels line an ``nms_sweep`` entry
(``max_abs_err`` over the keep masks as 0 / 1, with
``differing_decisions`` and ``worst_distance``).

Then the sequence-tagging slice, after B4 (``tagging_phases``):

SQ1. every new op on the card against the port's CPU result on one seeded
    float32 input, forward and backward, within 1e-4 of the CPU result's
    rms, integer outputs equal: the CRF loss, Viterbi and
    ``crf_decoding`` at SQ2's [300, 64, 57] and SQ3's [32, 128, 7] with
    ragged lengths including 1 and T (a differing Viterbi path passes only
    where the CPU scores both paths within 1e-5 relative, each printed);
    the 14 sequence ops at [300, 64, 128]; ``beam_search`` at 64 x 4 x 4
    with finished beams; ``hash`` over the full int64 range bit-equal; the
    extras ops and ``fluid.layers``' resize / pad / crop / grid-sampling /
    ``similarity_focus`` names at the CPU tests' shapes; the random ops'
    invariants on the card;
SQ2. LAC's BiGRU-CRF (``lexical_analysis`` nets.py: embedding(20940,
    128), 2 x BiGRU of 128, fc(57), ``linear_chain_crf`` and
    ``crf_decoding`` on a ``create_parameter`` transition, Adam(1e-3))
    through the 1.x static graph at batch 300 x 64 on seeded Markov-chain
    data (departures in ``SQ2_CONFIG``): 2 warm-up and 5 timed
    ``exe.run`` steps, then ``run_steps`` windows of 10 (eager, capture,
    replay): losses finite and the last window's mean below the first
    timed step's; a window under deterministic algorithms bit-equal to 10
    ``exe.run`` steps from the same state; ``fluid.io`` persistables
    reloaded into a fresh program decode bit-equal; the decoded paths
    equal to the CPU route on the same scope (SQ1's tie rule); sentences/s
    and tokens/s eager and replayed, kernels a step (``torch.profiler``),
    the CRF's CUDA-event ms and share, ``ChunkEvaluator``'s P / R / F1;
SQ3. a BERT-base CRF tagger (``BertModel(bert_base())`` bf16,
    ``Linear(768, 7)``, a float32 ``[9, 7]`` transition) through
    ``Model.train_batch`` at PaddleNLP msra_ner's 32 x 128, AdamW(2e-5,
    wd 0.01, multi_precision), 3 warm-up and 10 timed steps: kernel 2 24
    forward and 24 backward launches a step, no timed loss above 1.25x
    the first step's, a check step whose 24 + 24 kernel-2 calls equal the
    plain versions on their inputs (phase 6's tolerances), the decode
    equal to the CPU route's; ms a step, seq/s, tokens/s, the CRF's ms
    and share;
SQ4. one Program of ``nce`` (seeded negatives), ``center_loss``,
    ``sequence_conv``, ``data_norm``, ``inplace_abn``, ``lstm``,
    ``lstm_unit``, ``gru_unit``, ``dynamic_lstm`` (peepholes),
    ``dynamic_lstmp`` and ``dynamic_gru`` (both origin modes) through two
    Adam ``exe.run`` steps on the card and on the CPU from one state:
    fetches, parameters and buffers within 1e-4 of the rms.
A ``{"tagging": ...}`` line carries SQ1-SQ4's numbers; kernel 2's entry in
the kernels line gains ``tagging_launches`` and ``tagging_path_checks``
(SQ3's).

Distributed execution (after SQ4; ``distributed_phases``).  One card: the
multi-rank legs are ranks sharing cuda:0 over a gloo group (NCCL refuses
two ranks on one card), every collective staged through pinned host
buffers, so their times measure kernels and host copies, never an
interconnect.  The single-rank references (DX2's and DX3's models
through the plain ``train_batch``) run first in this process, then one
4-rank world runs DX1-DX3:

DX1. every collective of ``distributed.collective`` on card tensors, each
    rank's result = its slot of the stacked result JAX's semantics give
    (float sums within 1e-6 x ranks of the largest magnitude, bf16 sums
    within 2^-7);
DX2. ``gpt_small`` f32, dropout 0, ``fleet`` sharding 2 x model 2,
    AdamW(1e-4, wd 0.01, multi_precision), global batch 8 x 1024, 3
    steps: losses within 1e-4 (relative) of one rank's, the gathered
    parameters within 1e-4 of their rms in L2; qkv / fc1 / the table hold
    half their columns / rows, qkv's ZeRO slots half of that; kernels 2 /
    3 12 + 12 / 1 a step on every rank;
DX3. the long-context model in bf16 with ``sequence_parallel="ring"``,
    sep 2 x model 2, 2 x 8192, 3 steps: losses within 2e-2 of the LT2
    path's; kernels 4, 5, 6 12 x the ring schedule's chunks a step on
    every rank; the first step's ring chunks recorded and each held to
    its plain version on its own inputs (out within ``FLASH_TOL``, the
    gradients within 2e-2 of theirs in L2); a Ulysses forward of the block
    stack against the ring's (2e-2 in L2);

then DX4, ``DataParallel`` over a conv net with ``SyncBatchNorm`` at 2
ranks (gradients and statistics = the whole batch's on one rank), DX0,
the NCCL route at world size 1 in this process (every collective on card
tensors, no staging; ``fleet.init`` with every degree 1 training
``gpt_small`` f32 2 steps bit for bit the plain path), and kernels 4-6
timed at DX3's chunk shape.  Each leg prints its seconds, steps/s, peak
memory per rank and ``collective_stats()``; a ``{"distributed": ...}``
line carries them, and kernels 2-6 gain their DX launches
(``distributed_launches_per_step``, ``ring_launches_per_step``) and the
chunk's numbers (``ring_chunk``).

The line before last is the ``{"kernels": [...]}`` JSON record (kernel
1's entries carry D4's launches by engine under ``handoff_launches`` and
D3's paged run's under ``bench_paged_launches``, kernel 9's D5's quantized
dense engine's under ``dense_engine_launches`` and D4's int8 ones;
``layernorm_residual``'s entry carries its backward kernel's numbers
under ``backward``: launches in phase 7, max_abs_err, ms, bound, plain and
library; its mixed-dtype numbers under ``mixed_dtypes``, and F2's and F4's
launches beside phase 7's); the last line is ``{"ok": true, "device":
{...}}``.  Without a
card, or without the package beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 0
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
TENSOR_8BIT_OPS = 1979e12      # H100 SXM dense int8 / fp8 tensor-core rate
# the serving shapes: gpt_small heads, 16-token pages, batch 8, 1024 ctx
B, H, HD, PAGE, G = 8, 12, 64, 16, 64
VERIFY_T = (1, 5, 48)          # decode, 1 + speculative_k, largest bucket
QUANT_T = (1, 5, 16, 48)       # ... and the small bucket, quantized pools
QUANT_MODES = ("int8", "fp8")
# the quantized linears of a gpt_small block: qkv, out, fc1, fc2 as (K, N);
# M = B*T: decode, the 1 + k verify step, the largest admission
QMM_KN = {"qkv": (768, 2304), "out": (768, 768), "fc1": (768, 3072),
          "fc2": (3072, 768)}
QMM_M = (8, 40, 384)
MARGIN_K = 4.0                 # tools/quant_smoke.py's clear-margin factor
NUM_REQUESTS = 16
D_PASSES = 2                   # timed passes of the requests in D1 / D2
D4_REQUESTS = 8                # phase 4's first requests, one at a time
ENGINE = dict(prompt_buckets=[16, 48], batch_size=8, kv_page_size=16,
              speculative_k=4, paged=True)
MARGIN_TIE = 1e-4
# the training path: BERT-base pretraining (bench.py's shapes) and
# GPT-small training (__graft_entry__._dryrun_impl's optimizer)
BERT_B, BERT_S, BERT_P = 256, 128, 20
BERT_WARMUP, BERT_STEPS = 3, 10
GPT_B, GPT_S = 8, 1024
GPT_WARMUP, GPT_STEPS = 2, 3
PARITY_B = 4


def log(*a):
    print(*a, flush=True)


_START = [time.monotonic()]


def submark(name):
    """A line with the seconds since the smoke began, between sub-phases
    (where a slow run lost its time)."""
    log(f"smoke:   {name} at {time.monotonic() - _START[0]:.1f}s")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def geometry(torch, T, dtype, gen, n_copies=1, dims=None):
    """A ragged paged layout at the serving shapes: slot b holds
    ``lengths[b]`` tokens on randomly placed physical pages, the rest of
    its table is unmapped (-1, clipped to page 0 with mask 0); row 0 of
    slot 1 is fully masked.  ``n_copies`` pool pairs let timing loops
    rotate past the L2 cache.  ``dims`` = (batch, heads, head_dim, page,
    pages a slot, pool pages without the drop page) replaces the serving
    shapes."""
    nb, nh, hd, page, ng, npool = dims or (B, H, HD, PAGE, G, B * G)
    assert nb * ng <= npool, dims
    C = ng * page
    step = min(97, (C - T - 1) // max(nb - 1, 1))
    lengths = [C - 1 - step * b for b in range(nb)]
    perm = torch.randperm(npool, generator=gen).tolist()
    tables = torch.full((nb, ng), -1, dtype=torch.int32)
    nxt = 0
    for b in range(nb):
        for g in range(-(-lengths[b] // page)):
            tables[b, g] = perm[nxt]
            nxt += 1
    kp = torch.arange(C)
    mask = torch.zeros(nb, T, C, dtype=torch.bool)
    for b in range(nb):
        mapped = (tables[b] >= 0).repeat_interleave(page)
        for t in range(T):
            mask[b, t] = mapped & (kp <= lengths[b] - T + t)
    mask[min(1, nb - 1), 0] = False
    q = torch.randn(nb, nh, T, hd, generator=gen).to(DEVICE, dtype)
    pools = [tuple(torch.randn(npool + 1, nh, page, hd, generator=gen).to(
        DEVICE, dtype) for _ in range(2)) for _ in range(n_copies)]
    return (q, pools, tables.clamp_min(0).to(DEVICE).contiguous(),
            mask.to(DEVICE), tables)


def bound(q, tables_raw, mask, quantized=False):
    """Least time the card needs for one call: the larger of the bytes
    this call must move (valid K/V pages — one byte an element plus a
    float32 scale a key for a quantized pool — q, mask, tables in; out)
    over HBM bandwidth and its flops (QK and PV over the valid keys) over
    the float32 rate."""
    Bq, Hq, T, hd = q.shape
    item = q.element_size()
    used = mask.reshape(Bq, T, G, PAGE).any(dim=(1, 3))  # [B, G] page read
    valid_pages = int(used.sum())
    kv_bytes = valid_pages * Hq * PAGE * (hd + 4 if quantized
                                          else hd * item) * 2
    io_bytes = (2 * q.numel() * item + mask.numel()
                + tables_raw.numel() * 4)
    nbytes = kv_bytes + io_bytes
    flops = 4.0 * Hq * T * valid_pages * PAGE * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def time_ms(torch, fn, pools, iters):
    """Mean ms per call from CUDA events over ``iters`` calls that rotate
    through ``pools`` (more bytes than the 50 MB L2 holds), after a
    warm-up."""
    for i in range(3):
        fn(*pools[i % len(pools)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*pools[i % len(pools)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_GRAPH_STREAM = None


def graph_ms(torch, fn, pools, iters):
    """Mean device ms per call: ``iters`` calls rotating through ``pools``,
    captured once in a CUDA graph and replayed three times between CUDA
    events.  The host's per-call work (argument checks, allocation, the
    ctypes call) is left out: what the call costs the card, where
    :func:`time_ms` is bounded below by the Python that launches it
    (~0.017 ms a call for ``quantized_matmul``)."""
    global _GRAPH_STREAM
    if _GRAPH_STREAM is None:
        # one capture stream for every call: cuBLAS keeps a workspace per
        # stream it ran on (the library yardsticks), so a new stream per
        # call would leave ~30 MiB allocated each time
        _GRAPH_STREAM = torch.cuda.Stream()
    side = _GRAPH_STREAM
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(*pools[i % len(pools)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(*pools[i % len(pools)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * iters)


def check_kernels(torch):
    """Phase 3: kernel vs plain version at the serving shapes."""
    from paddle_tpu_torch.ops.paged_attention import (
        paged_flash_decode, paged_flash_decode_ref)
    gen = torch.Generator().manual_seed(SEED)
    max_err = 0.0
    for dtype, tol in ((torch.float32, dict(rtol=1e-4, atol=2e-5)),
                       (torch.bfloat16, dict(rtol=2e-2, atol=2e-2))):
        for T in VERIFY_T:
            q, pools, tab, mask, _ = geometry(torch, T, dtype, gen)
            kp, vp = pools[0]
            out = paged_flash_decode(q, kp, vp, tab, mask)
            ref = paged_flash_decode_ref(q, kp, vp, tab, mask)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, **tol)
            dead = ~mask.any(-1)  # [B, T] fully-masked rows
            assert int(dead.sum()) >= 1
            assert torch.all(out.permute(0, 2, 1, 3)[dead] == 0), \
                "fully-masked rows must be exactly 0"
            err = float((out.float() - ref.float()).abs().max())
            if dtype == torch.float32:
                max_err = max(max_err, err)
            log(f"kernel paged_flash_decode {str(dtype)[6:]} T={T}: "
                f"max_abs_err={err:.3e} vs plain (rtol={tol['rtol']}, "
                f"atol={tol['atol']}) ok")
        for T in (1, 5):
            q, pools, tab, mask, _ = geometry(torch, T, dtype, gen)
            paged_edges(torch, (q, *pools[0], tab, mask), tol,
                        f"{str(dtype)[6:]} T={T}")
    return max_err


def paged_edges(torch, args, tol, label):
    """The split design's edges at the serving shapes: slot 7 with no valid
    page, slot 6 with one (so every share of its split but one holds no
    valid key), row 0 of slot 1 masked everywhere; against the plain
    version, the dead rows exactly 0, two calls bit-equal."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import paged_attention as pa

    q, k, v, tab, mask = args[:5]
    mask = mask.clone()
    mask[7] = False
    mask[6, :, PAGE:] = False
    args = (q, k, v, tab, mask, *args[5:])
    plan = pa._plan(B, H, q.shape[2], HD, PAGE, G, k.element_size(),
                    _build.sm_count(q.device))
    assert plan[0] == "split", plan
    out = pa.paged_flash_decode(*args)
    out2 = pa.paged_flash_decode(*args)
    ref = pa.paged_flash_decode_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **tol)
    assert torch.equal(out, out2), "two calls differ"
    assert not bool(out[7].any()) and not bool(out[1, :, 0].any())
    log(f"kernel paged_flash_decode {label} edges (plan {plan}: a slot with "
        f"no valid page, a slot with one, so shares of its split hold no "
        f"valid key; G = {G} pages over a split of {plan[1]}): "
        f"max_abs_err={float((out.float() - ref.float()).abs().max()):.3e} "
        f"vs plain, dead rows exactly 0, two calls bit-equal; ok")


def greedy_margin_check(torch, model, prompt, served, vocab):
    """Hold ``served`` tokens against uncached greedy ``forward`` on the
    card.  Returns (tokens compared, near-ties); raises on a clear-margin
    flip.  The uncached ``forward`` runs every block's residual add +
    LayerNorm through the fused ``layernorm_residual`` kernel, while the
    paged path keeps the unfused ``x + a; ln2(x)``: this yardstick is not
    plain PyTorch alone, and phase 6 holds that kernel to its plain
    version separately."""
    ids = torch.tensor([list(map(int, prompt))], device=model.device)
    with torch.no_grad():
        for j, tok in enumerate(served):
            logits = model(ids)[0, -1]
            assert logits.shape == (vocab,) and bool(torch.isfinite(
                logits).all()), "uncached logits not finite"
            top2 = torch.topk(logits, 2)
            ref = int(top2.indices[0])
            if ref != int(tok):
                margin = float(top2.values[0] - top2.values[1])
                assert margin < MARGIN_TIE, (
                    f"clear-margin flip at token {j}: served {tok}, "
                    f"greedy {ref}, margin {margin:.3e}")
                return j, 1
            ids = torch.cat([ids, top2.indices[:1].view(1, 1)], dim=1)
    return len(served), 0


def requests():
    """The served workload: 16 seeded requests, prompts of 4-48 tokens,
    16-64 new tokens; the first and the last share a 20-token system
    prompt (the last is admitted after the first registered it)."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    system = rng.randint(0, 50257, size=20)
    reqs = []
    for i in range(NUM_REQUESTS):
        if i in (0, NUM_REQUESTS - 1):
            prompt = np.concatenate([system, rng.randint(0, 50257,
                                                         size=4 + i % 8)])
            kw = dict(prefix_key="system", prefix_len=len(system))
        else:
            prompt = rng.randint(0, 50257, size=rng.randint(4, 49))
            kw = {}
        reqs.append((prompt.astype(np.int32), int(rng.randint(16, 65)), kw))
    return reqs


def build_serve_model(torch):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_small

    cfg = gpt_small(dropout=0.0)
    t0 = time.monotonic()
    model = GPTForCausalLM(cfg, device=DEVICE,
                           generator=torch.Generator().manual_seed(SEED))
    log(f"serve: gpt_small vocab={cfg.vocab_size} hidden={cfg.hidden_size} "
        f"layers={cfg.num_layers} heads={cfg.num_heads} "
        f"params={sum(p.numel() for p in model.parameters())} "
        f"built in {time.monotonic() - t0:.1f}s")
    return model


def fingerprint(torch, model):
    """Bit-level checksums of every tensor of ``model`` (name, dtype, sum
    of the raw 32-bit words)."""
    return [(k, v.dtype, int(v.contiguous().view(torch.int32).sum(
        dtype=torch.int64))) for k, v in model.state_dict().items()]


def serve(torch, gpu, model, quantized=None):
    """Phases 4, Q3, M4 and E3's paged half: GPT-2-small-width paged
    serving through the kernels, float, (``quantized``) int8 / fp8, or an
    MoE model (its expert FFNs through ``grouped_matmul``, 2 launches a
    layer a call, and its routed-token counter held to the rows the decode
    steps routed), quantized too (then only qkv / out are quantized: 2
    ``quantized_matmul`` launches a layer a call, and E3's logit gate)."""
    from paddle_tpu_torch.ops import grouped_matmul
    from paddle_tpu_torch.ops.paged_attention import paged_flash_decode
    from paddle_tpu_torch.ops.quantized_matmul import quantized_linear
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = model.gpt.cfg
    moe = bool(cfg.moe_experts)
    kind = "-".join(k for k in ("moe" if moe else None, quantized) if k) \
        or "float"
    tag = f"serve[{kind}]"
    reqs = requests()
    gc.collect()  # an earlier engine (a reference cycle) frees its model copy
    torch.cuda.reset_peak_memory_stats()
    with GenerationEngine(model, name=f"chip-smoke-{kind}",
                          quantized=quantized, **ENGINE) as eng:
        t0 = time.monotonic()
        eng.warmup()
        log(f"{tag}: warmup {time.monotonic() - t0:.2f}s")
        widths = []  # the step width T of every decode step
        if moe:
            step = eng._step

            def counted_step(packed, cache):
                G = eng._C // eng._page
                widths.append((packed.shape[1] - eng._C - G) // 2)
                return step(packed, cache)

            eng._step = counted_step
        if quantized is not None:
            assert eng.quant_active and eng._model is not model
            pool = eng._new_cache()["layers"][0]
            want = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[quantized]
            assert pool["k"].dtype == want and pool["v"].dtype == want, pool
            assert pool["k_scale"].dtype == torch.float32 and tuple(
                pool["v_scale"].shape) == tuple(pool["k"].shape[:3])
            log(f"{tag}: pool {pool['k'].dtype} {tuple(pool['k'].shape)}, "
                f"scale planes float32 {tuple(pool['k_scale'].shape)}")
            del pool
        st0 = eng.stats()
        paged_flash_decode.launches = 0
        quantized_linear.launches = 0
        grouped_matmul.launches = 0
        t0 = time.monotonic()
        futs = [eng.submit(p, n, **kw) for p, n, kw in reqs]
        outs = [f.result(600) for f in futs]
        wall = time.monotonic() - t0
        launches = paged_flash_decode.launches
        qmm_launches = quantized_linear.launches
        gmm_launches = grouped_matmul.launches
        st = eng.stats()
    calls = ((st["batches"] - st0["batches"])
             + (st["decode_steps"] - st0["decode_steps"]))
    want_qmm = ((2 if moe else 4) * cfg.num_layers * calls if quantized
                else 0)
    want_gmm = 2 * cfg.num_layers * calls if moe else 0
    log(f"{tag}: grouped_matmul launches {gmm_launches} (= {want_gmm}: "
        f"{gmm_launches == want_gmm})")
    assert gmm_launches == want_gmm, (gmm_launches, want_gmm)
    if moe:
        # capacity factor E: C = k x N, so every routed row is kept; the
        # counter is each post-warm step's routed rows summed over layers
        routed = st["moe_routed_tokens"] - st0["moe_routed_tokens"]
        want = sum(cfg.num_layers * cfg.moe_top_k * ENGINE["batch_size"] * w
                   for w in widths)
        log(f"{tag}: moe_routed_tokens {routed} (= layers x top_k x batch "
            f"x step width over {len(widths)} decode steps: {want}), "
            f"moe_dropped_tokens {st['moe_dropped_tokens']}, overflow "
            f"fraction {st['moe_overflow_frac']}, dead experts "
            f"{st['moe_dead_experts']}")
        assert len(widths) == st["decode_steps"] - st0["decode_steps"]
        assert routed == want and st["moe_dropped_tokens"] == 0, st
        assert st["moe_sampled_steps_after_warm"] == len(widths), st
    log(f"{tag}: {len(outs)} requests, admission calls "
        f"{st['batches'] - st0['batches']}, decode steps "
        f"{st['decode_steps'] - st0['decode_steps']}, paged_flash_decode "
        f"launches {launches} (= {cfg.num_layers} x {calls}: "
        f"{launches == cfg.num_layers * calls}), quantized_matmul launches "
        f"{qmm_launches} (= {want_qmm}: {qmm_launches == want_qmm})")
    assert st["completed"] == NUM_REQUESTS and st["errors"] == 0, st
    assert launches > 0 and launches == cfg.num_layers * calls, \
        (launches, calls)
    assert qmm_launches == want_qmm, (qmm_launches, want_qmm)
    assert st["kv_pages_leaked"] == 0 and st["prefix_hits"] >= 1, st
    n_tok = 0
    for (p, n, _), out in zip(reqs, outs):
        assert out.shape == (n,) and out.min() >= 0 \
            and out.max() < cfg.vocab_size, (out.shape, n)
        n_tok += len(out)
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag}[{gpu}]: {n_tok} tokens in {wall:.3f}s = "
        f"{n_tok / wall:.1f} tokens/s, mean request latency "
        f"{st['mean_ms']:.1f} ms (p99 {st['p99_ms']:.1f} ms), "
        f"spec drafted/accepted {st['spec_drafted']}/{st['spec_accepted']}, "
        f"cow copies {st['cow_copies']}, peak device memory "
        f"{peak / 2**20:.0f} MiB")
    logits = None
    if quantized is None:  # float and MoE models
        compared = ties = 0
        for (p, _, _), out in list(zip(reqs, outs))[:4]:
            c, t = greedy_margin_check(torch, model, p, out.tolist(),
                                       cfg.vocab_size)
            compared += c
            ties += t
        assert compared >= 20, compared
        log(f"{tag}: {compared} tokens of 4 requests agree with uncached "
            f"greedy on the card ({ties} near-tie divergences, 0 "
            f"clear-margin flips)")
    else:
        quant_agreement(torch, model, quantized, reqs, outs)
        if moe:
            logits = moe_quant_logits(torch, model, quantized, [
                [int(t) for t in p] + out.tolist()[:-1]
                for (p, _, _), out in zip(reqs, outs)], tag)
    return {"launches": launches, "qmm_launches": qmm_launches,
            "logits_vs_float": logits,
            "gmm_launches": gmm_launches,
            "gmm_launches_per_call": gmm_launches / calls,
            "launches_per_call": launches / calls,
            "qmm_launches_per_call": qmm_launches / calls,
            "tokens_per_s": n_tok / wall, "mean_ms": st["mean_ms"],
            "p99_ms": st["p99_ms"], "peak_bytes": peak}


def quant_agreement(torch, model, mode, reqs, outs):
    """The margin rule of tools/quant_smoke.py on the served tokens: the
    float model and a quantized copy are teacher-forced over each served
    history (one dense forward a request); tau = MARGIN_K x the largest
    quantized-vs-float logit difference is the calibrated noise; a served
    token that is not the float top-1 must sit at a float margin <= tau.
    Agreement is reported; a clear-margin flip raises."""
    from paddle_tpu_torch import slim

    qmodel = slim.quantize_model(model, mode)
    delta, margins, agrees = 0.0, [], []
    with torch.no_grad():
        for (p, _, _), out in zip(reqs, outs):
            hist = torch.tensor([[int(t) for t in p] + out.tolist()[:-1]],
                                device=model.device)
            lf = model(hist)[0, len(p) - 1:]       # row j predicts out[j]
            lq = qmodel(hist)[0, len(p) - 1:]
            assert bool(torch.isfinite(lq).all()), "quantized logits"
            delta = max(delta, float((lq - lf).abs().max()))
            top2 = torch.topk(lf, 2, dim=-1)
            margins += (top2.values[:, 0] - top2.values[:, 1]).tolist()
            agrees += (top2.indices[:, 0].cpu()
                       == torch.from_numpy(out).long()).tolist()
    tau = MARGIN_K * delta
    clear = [a for m, a in zip(margins, agrees) if m > tau]
    flips = len(clear) - sum(clear)
    log(f"serve[{mode}]: agreement with the float model's top-1 "
        f"{sum(agrees)}/{len(agrees)} = {sum(agrees) / len(agrees):.3f}; "
        f"largest logit difference {delta:.4f}, tau = {MARGIN_K:g} x that = "
        f"{tau:.4f}; {len(clear)} tokens at a clear margin, {flips} of "
        f"them flipped")
    assert flips == 0, f"{flips} clear-margin flips under {mode}"
    del qmodel


# -- the default serving engines (D1-D5) -------------------------------------
def busy_share(torch, run):
    """Run ``run()`` under ``torch.profiler`` and return (device-busy ms,
    window ms): the summed device time of every kernel and copy (one
    stream) over the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = 0.0
    for e in prof.key_averages():
        if "CUDA" in str(e.device_type):
            us = getattr(e, "self_device_time_total", None)
            busy += float(e.self_cuda_time_total if us is None else us)
    return busy / 1e3, wall


@contextlib.contextmanager
def path_shapes():
    """Record the shapes the serving path hands kernels 1 and 9: a
    pass-through around the two names the model calls them by
    (``models/gpt.py``'s ``paged_flash_decode``, the quantized Linear's
    ``quantized_linear``).  It launches and counts nothing itself, so the
    launch counters read as they would without it."""
    from paddle_tpu_torch.distributed import meta_parallel
    from paddle_tpu_torch.models import gpt

    seen = {"paged": set(), "qmm": set()}
    paged, qlin = gpt.paged_flash_decode, meta_parallel.quantized_linear

    def rec_paged(q, k, v, tab, mask, k_scale=None, v_scale=None):
        seen["paged"].add((tuple(q.shape), tuple(k.shape), q.dtype, k.dtype,
                           tuple(tab.shape)))
        return paged(q, k, v, tab, mask, k_scale, v_scale)

    def rec_qlin(x, w, scale, bias=None):
        seen["qmm"].add((x.numel() // x.shape[-1], *w.shape, w.dtype))
        return qlin(x, w, scale, bias)

    gpt.paged_flash_decode = rec_paged
    meta_parallel.quantized_linear = rec_qlin
    try:
        yield seen
    finally:
        gpt.paged_flash_decode = paged
        meta_parallel.quantized_linear = qlin


def check_path_kernels(torch, seen, label):
    """Kernels 1 and 9 against their plain versions at every shape a
    phase's engines handed them (``path_shapes``), on seeded inputs:
    kernel 1 on a ragged layout at that batch, heads, step width,
    head_dim, page, table width and pool size, the pools quantized as
    the path's are, at phase 3's / Q2's tolerance (float32 q: rtol 1e-4,
    atol 2e-5), fully-masked rows exactly 0; kernel 9 as in Q1.  Returns
    {kernel: {"shapes": [...], "max_abs_err": x}}."""
    from paddle_tpu_torch.ops.paged_attention import (
        paged_flash_decode, paged_flash_decode_ref)

    gen = torch.Generator().manual_seed(SEED + 17)
    out = {}
    qtypes = (torch.int8, torch.float8_e4m3fn)
    if seen["paged"]:
        worst, shapes = 0.0, []
        for qs, ks, qdt, kdt, ts in sorted(seen["paged"], key=str):
            nb, nh, T, hd = qs
            q, pools, tab, mask, _ = geometry(
                torch, T, qdt, gen, dims=(nb, nh, hd, ks[2], ts[1],
                                          ks[0] - 1))
            args = (q, *pools[0], tab, mask)
            if kdt in qtypes:
                k, v, ksc, vsc = quantize_pools(torch, *pools[0], kdt)
                args = (q, k, v, tab, mask, ksc, vsc)
            tol = (dict(rtol=2e-2, atol=2e-2) if qdt == torch.bfloat16
                   else dict(rtol=1e-4, atol=2e-5))
            got = paged_flash_decode(*args)
            ref = paged_flash_decode_ref(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, **tol)
            dead = ~mask.any(-1)
            assert int(dead.sum()) >= 1 and torch.all(
                got.permute(0, 2, 1, 3)[dead] == 0), "dead rows must be 0"
            err = float((got.float() - ref.float()).abs().max())
            worst = max(worst, err)
            shape = (f"q {list(qs)} {str(qdt)[6:]}, pool {list(ks)} "
                     f"{str(kdt)[6:]}, table {list(ts)}")
            shapes.append(shape)
            log(f"{label}: kernel paged_flash_decode at the path's {shape}: "
                f"max_abs_err={err:.3e} vs plain (rtol={tol['rtol']}, "
                f"atol={tol['atol']}), dead rows 0; ok")
            del q, pools, tab, mask, args, got, ref
        out["paged_flash_decode"] = {"shapes": shapes, "max_abs_err": worst}
    if seen["qmm"]:
        worst, shapes = 0.0, []
        for M, K, N, wdt in sorted(seen["qmm"], key=str):
            mode = "int8" if wdt == torch.int8 else "fp8"
            err = qmm_check(torch, mode, M, K, N, gen, label)
            worst = max(worst, err)
            shapes.append(f"{mode} [{M}, {K}] @ [{K}, {N}]")
        log(f"{label}: kernel quantized_matmul at the path's {shapes}: "
            f"max_abs_err={worst:.3e} vs plain (int8 bit-equal, fp8 rtol "
            f"1e-4, atol 1e-4 x max|out|); ok")
        out["quantized_matmul"] = {"shapes": shapes, "max_abs_err": worst}
    return out


def serve_dense(torch, gpu, model, continuous=True, d1_outs=None):
    """Phases D1 (``continuous``) and D2 (legacy): the default engine
    over phase 4's model and requests, ``D_PASSES`` timed passes of them
    (tokens/s as the median and the range of the passes)."""
    from paddle_tpu_torch.ops.paged_attention import paged_flash_decode
    from paddle_tpu_torch.ops.quantized_matmul import quantized_linear
    from paddle_tpu_torch.serving import GenerationEngine

    tag = "D1" if continuous else "D2"
    cfg = model.gpt.cfg
    reqs = requests()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    kw = {} if continuous else dict(continuous=False)
    with GenerationEngine(model, prompt_buckets=[16, 48], batch_size=8,
                          name=f"chip-smoke-{tag}", **kw) as eng:
        st = eng.stats()
        assert st["continuous"] == continuous and not st["paged"], st
        t0 = time.monotonic()
        eng.warmup()
        ring = eng._ring()
        ring_bytes = sum(t.numel() * t.element_size() for l in ring["layers"]
                         for t in l.values())
        log(f"{tag}: warmup {time.monotonic() - t0:.2f}s, ring "
            f"{tuple(ring['layers'][0]['k'].shape)} x 2 x {cfg.num_layers} "
            f"{ring['layers'][0]['k'].dtype} = {ring_bytes} bytes")
        st0 = eng.stats()
        paged_flash_decode.launches = 0
        quantized_linear.launches = 0
        walls, passes = [], []
        for _ in range(D_PASSES):
            t0 = time.monotonic()
            futs = [eng.submit(p, n) for p, n, _ in reqs]
            passes.append([f.result(600) for f in futs])
            walls.append(time.monotonic() - t0)
        launches = (paged_flash_decode.launches, quantized_linear.launches)
        st = eng.stats()
        peak = torch.cuda.max_memory_allocated()
        busy, window = busy_share(torch, lambda: [
            f.result(600) for f in [eng.submit(p, n) for p, n, _ in reqs]])
    assert st["completed"] - st0["completed"] == NUM_REQUESTS * D_PASSES, st
    assert st["errors"] == 0, st
    assert launches == (0, 0), launches
    outs = passes[0]
    n_tok = 0
    for (p, n, _), out in zip(reqs, outs):
        assert out.shape == (n,) and out.min() >= 0 \
            and out.max() < cfg.vocab_size, (out.shape, n)
        n_tok += n
    steps = st["decode_steps"] - st0["decode_steps"]
    calls = st["batches"] - st0["batches"]
    if d1_outs is None:
        compared = ties = 0
        for (p, _, _), out in list(zip(reqs, outs))[:4]:
            c, t = greedy_margin_check(torch, model, p, out.tolist(),
                                       cfg.vocab_size)
            compared += c
            ties += t
        assert compared >= 20, compared
        log(f"{tag}: {compared} tokens of 4 requests agree with uncached "
            f"greedy on the card ({ties} near-tie divergences)")
        same = None
    else:
        same = sum(a.tolist() == b.tolist() for a, b in zip(outs, d1_outs))
        for (p, _, _), a, b in zip(reqs, outs, d1_outs):
            if a.tolist() != b.tolist():  # then it must be a near-tie
                greedy_margin_check(torch, model, p, a.tolist(),
                                    cfg.vocab_size)
        log(f"{tag}: tokens equal D1's in {same} of {NUM_REQUESTS} "
            f"requests (the others diverge at a near-tie of greedy)")
    # the later passes against the first (a batch of another make-up may
    # round differently: a divergence must be a near-tie)
    repeat = 0
    for later in passes[1:]:
        for (p, _, _), a, b in zip(reqs, later, outs):
            if a.tolist() == b.tolist():
                repeat += 1
            else:
                greedy_margin_check(torch, model, p, a.tolist(),
                                    cfg.vocab_size)
    rates = sorted(n_tok / w for w in walls)
    median = rates[len(rates) // 2]
    r = {"tokens_per_s": median, "tokens_per_s_passes": [
        n_tok / w for w in walls], "passes": D_PASSES,
         "mean_ms": st["mean_ms"], "p99_ms": st["p99_ms"],
         "peak_bytes": peak, "ring_bytes": ring_bytes,
         "decode_steps": steps,
         "admission_calls" if continuous else "batches": calls,
         "busy_ms": busy, "window_ms": window,
         "busy_share": busy / window,
         "later_passes_equal_to_first": repeat}
    if same is not None:
        r["requests_equal_to_d1"] = same
    log(f"{tag}[{gpu}]: {n_tok} tokens a pass, {D_PASSES} passes: median "
        f"{median:.1f} tokens/s (range {rates[0]:.1f}-{rates[-1]:.1f}), "
        f"mean request latency {st['mean_ms']:.1f} ms (p99 "
        f"{st['p99_ms']:.1f} ms), {steps} decode steps, {calls} "
        f"{'admissions' if continuous else 'batches'}, later passes equal "
        f"to the first in {repeat} of {NUM_REQUESTS * (D_PASSES - 1)} "
        f"requests, peak device memory {peak / 2**20:.0f} MiB; device busy "
        f"{busy:.1f} ms of a {window:.1f} ms profiled pass = "
        f"{100 * busy / window:.1f}%")
    return r, outs


def bench_generate(torch, gpu):
    """Phase D3: bench.py's ``bench_gpt_generate`` body in the port."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.ops.paged_attention import paged_flash_decode
    from paddle_tpu_torch.serving import GenerationEngine
    from paddle_tpu_torch.tuning import RequestTrace, replay

    paddle.seed(1234)
    cfg = GPTConfig(vocab_size=8192, hidden_size=256, num_layers=4,
                    num_heads=8, max_position=512, dropout=0.0)
    model = GPTForCausalLM(cfg)
    model.eval()
    trace = RequestTrace.synthetic()

    def run(continuous, paged=False):
        kind = "paged" if paged else "cont" if continuous else "legacy"
        with GenerationEngine(
                model, prompt_buckets=[16, 48], batch_size=8,
                max_queue_delay_ms=1.0, continuous=continuous, paged=paged,
                name=f"bench-gen-{kind}") as eng:
            eng.warmup()
            paged_flash_decode.launches = 0
            stats = replay(eng, trace)
            launches = paged_flash_decode.launches
            outs = [f.result(600).tolist()
                    for f in [eng.submit(p, n) for p, n in trace]]
            return stats, eng.stats(), launches, outs

    with path_shapes() as seen:
        legacy, lsnap, l_launches, l_outs = run(False)
        cont, csnap, c_launches, c_outs = run(True)
        paged, psnap, p_launches, p_outs = run(True, paged=True)
    assert l_launches == c_launches == 0, (l_launches, c_launches)
    assert p_launches > 0 and p_launches % cfg.num_layers == 0, p_launches
    assert seen["paged"] and not seen["qmm"], seen
    checked = check_path_kernels(torch, seen, "D3")
    # the headline engine's own tokens: every request against uncached
    # greedy (a divergence must be a near-tie), then the others against it
    compared = ties = 0
    for (prompt, _), out in zip(trace, c_outs):
        c, t = greedy_margin_check(torch, model, prompt, out,
                                   cfg.vocab_size)
        compared += c
        ties += t
    assert compared >= 0.9 * trace.total_new_tokens, compared
    log(f"D3: continuous engine {compared} of {trace.total_new_tokens} "
        f"tokens of {len(trace)} requests agree with uncached greedy on "
        f"the card ({ties} near-tie divergences)")
    for name, outs in (("legacy", l_outs), ("paged", p_outs)):
        diff = [i for i, (a, b) in enumerate(zip(outs, c_outs)) if a != b]
        for i in diff:  # a divergence must be a near-tie of greedy
            greedy_margin_check(torch, model, trace.entries[i][0], outs[i],
                                cfg.vocab_size)
        log(f"D3: {name} tokens equal continuous in "
            f"{len(outs) - len(diff)} of {len(outs)} requests")
    line = {"metric": "gpt_generate_tokens_per_sec",
            "value": round(cont["tokens_per_sec"], 1), "unit": "tok/s",
            "vs_baseline": round(cont["tokens_per_sec"]
                                 / legacy["tokens_per_sec"], 3),
            "legacy_tokens_per_sec": round(legacy["tokens_per_sec"], 1),
            "paged_tokens_per_sec": round(paged["tokens_per_sec"], 1),
            "mean_latency_ms": round(cont["mean_ms"], 1),
            "legacy_mean_latency_ms": round(legacy["mean_ms"], 1),
            "paged_mean_latency_ms": round(paged["mean_ms"], 1),
            "requests": len(trace), "new_tokens": trace.total_new_tokens,
            "method": "continuous_batching_vs_legacy", "device": gpu}
    log(json.dumps(line))
    del model
    # steps over the replay and the check pass together
    return dict(line, paged_launches=p_launches, path_checks=checked,
                greedy_tokens_compared=compared,
                decode_steps={"legacy": lsnap["decode_steps"],
                              "continuous": csnap["decode_steps"],
                              "paged": psnap["decode_steps"]},
                p99_ms={"legacy": legacy["p99_ms"], "continuous":
                        cont["p99_ms"], "paged": paged["p99_ms"]},
                paged_spec_drafted=psnap["spec_drafted"],
                paged_spec_accepted=psnap["spec_accepted"])


def handoff(torch, gpu, model, quantized=None):
    """Phase D4: prefill-role → decode-role engines against one
    co-located paged engine, at phase 4's shape."""
    from paddle_tpu_torch.ops.paged_attention import paged_flash_decode
    from paddle_tpu_torch.ops.quantized_matmul import quantized_linear
    from paddle_tpu_torch.serving import GenerationEngine, KVHandoff

    import numpy as np

    tag = f"D4[{quantized or 'float'}]"
    L = model.gpt.cfg.num_layers
    reqs = requests()[:D4_REQUESTS]
    kw = dict(ENGINE, speculative_k=0, quantized=quantized)
    # one request at a time on every engine: the same shapes for the same
    # request (and, quantized, the same rows under each per-tensor
    # activation scale), so the tokens can be held bit for bit
    with GenerationEngine(model, name="chip-smoke-co", **kw) as co:
        co.warmup()
        want = [co.generate(p, n, timeout=600).tolist() for p, n, _ in reqs]
    with path_shapes() as seen, \
            GenerationEngine(model, role="prefill", name="chip-smoke-pre",
                             **kw) as pre, \
            GenerationEngine(model, role="decode", name="chip-smoke-dec",
                             **kw) as dec:
        pre.warmup()
        dec.warmup()
        counts = {}
        for eng, name in ((pre, "prefill"), (dec, "decode")):
            st0 = eng.stats()
            paged_flash_decode.launches = 0
            quantized_linear.launches = 0
            if name == "prefill":
                hands = [pre.submit(p, n, handoff=True).result(600)
                         for p, n, _ in reqs]
            else:
                got = [dec.submit(p, n, handoff=h).result(600).tolist()
                       for (p, n, _), h in zip(reqs, hands)]
            st = eng.stats()
            calls = ((st["batches"] - st0["batches"])
                     + (st["decode_steps"] - st0["decode_steps"]))
            counts[name] = {"paged_flash_decode": paged_flash_decode.launches,
                            "quantized_matmul": quantized_linear.launches,
                            "calls": calls}
            assert paged_flash_decode.launches == L * calls > 0, counts
            assert quantized_linear.launches == (
                4 * L * calls if quantized else 0), counts
        assert pre.stats()["handoffs_out"] == len(reqs)
        assert dec.stats()["handoffs_in"] == len(reqs)
        assert pre.stats()["decode_steps"] == 0
        # the transfers at the payload's full width (largest bucket)
        cache = pre._new_cache()
        idx = np.arange(pre._Gh, dtype=np.int32)
        payload = pre._export(cache, idx)
        nbytes = sum(a.nbytes for a in (payload if quantized
                                        else (payload,)))
        n = 20
        t0 = time.perf_counter()
        for _ in range(n):
            payload = pre._export(cache, idx)  # returns host arrays
        export_ms = (time.perf_counter() - t0) * 1e3 / n
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            dec._import(cache, payload, idx)
            torch.cuda.synchronize()
        import_ms = (time.perf_counter() - t0) * 1e3 / n
        del cache
    assert seen["paged"] and bool(seen["qmm"]) == bool(quantized), seen
    checked = check_path_kernels(torch, seen, tag)
    assert all(isinstance(h, KVHandoff) for h in hands)
    assert got == want, [i for i, (a, b) in enumerate(zip(got, want))
                         if a != b]
    log(f"{tag}[{gpu}]: {len(reqs)} hand-offs, tokens bit-identical to "
        f"the co-located engine; launches prefill {counts['prefill']}, "
        f"decode {counts['decode']}; payload {nbytes} bytes, export "
        f"{export_ms:.3f} ms, import {import_ms:.3f} ms")
    return {"launches": counts, "payload_bytes": nbytes,
            "export_ms": export_ms, "import_ms": import_ms,
            "path_checks": checked}


def weight_swaps(torch, gpu):
    """Phase D5: an int8 ``export_quantized`` artifact into a quantized
    dense engine, then a float side-file into a float one."""
    import shutil
    import tempfile

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import slim
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_small
    from paddle_tpu_torch.ops.quantized_matmul import quantized_linear
    from paddle_tpu_torch.serving import GenerationEngine

    def build(seed):
        return GPTForCausalLM(gpt_small(dropout=0.0), device=DEVICE,
                              generator=torch.Generator().manual_seed(seed))

    served, donor = build(SEED + 10), build(SEED + 11)
    L = served.gpt.cfg.num_layers
    reqs = requests()[:4]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_swap_")
    out = {}
    try:
        t0 = time.monotonic()
        art = slim.export_quantized(donor, os.path.join(tmp, "donor"),
                                    mode="int8")
        export_s = time.monotonic() - t0
        side = os.path.join(tmp, "donor_float.pdiparams")
        ptt.save({"params": dict(donor.named_parameters()), "buffers": {}},
                 side)
        # batch 1: a quantized linear's per-tensor activation scale sees
        # every row of a call, and a free row carries its slot's history
        kw = dict(prompt_buckets=[16, 48], batch_size=1)
        for mode, path in (("int8", art), (None, side)):
            with path_shapes() as seen:
                with GenerationEngine(donor, quantized=mode,
                                      name="chip-smoke-donor", **kw) as ref:
                    want = [ref.generate(p, n, timeout=600).tolist()
                            for p, n, _ in reqs]
                with GenerationEngine(served, quantized=mode,
                                      name="chip-smoke-swap", **kw) as eng:
                    eng.warmup()
                    before = eng.generate(reqs[0][0], reqs[0][1],
                                          timeout=600).tolist()
                    torch.cuda.synchronize()
                    t0 = time.monotonic()
                    eng.swap_weights(path)
                    torch.cuda.synchronize()
                    swap_s = time.monotonic() - t0
                    st0 = eng.stats()
                    quantized_linear.launches = 0
                    got = [eng.generate(p, n, timeout=600).tolist()
                           for p, n, _ in reqs]
                    launches = quantized_linear.launches
                    st = eng.stats()
            calls = ((st["batches"] - st0["batches"])
                     + (st["decode_steps"] - st0["decode_steps"]))
            assert got == want and before != want[0], (got, want)
            assert st["weight_swaps"] == 1, st
            assert launches == (4 * L * calls if mode else 0), (launches,
                                                                calls)
            assert not seen["paged"] and bool(seen["qmm"]) == bool(mode)
            name = mode or "float"
            out[name] = {"swap_s": swap_s,
                         "file_bytes": os.path.getsize(path),
                         "quantized_matmul_launches": launches,
                         "calls": calls,
                         "path_checks": check_path_kernels(
                             torch, seen, f"D5[{name}]")}
            log(f"D5[{gpu}] {name}: swap of {os.path.getsize(path)} bytes "
                f"in {swap_s:.3f}s; 4 requests now equal the donor "
                f"engine's tokens; {calls} calls, quantized_matmul "
                f"launches {launches}")
        out["int8"]["export_s"] = export_s
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del served, donor
    return out


def time_paged(torch, gpu, label, args, library, lib_name, bound_row):
    """Kernel 1 at one serving shape: device time (CUDA graph) and the
    eager call of the kernel and of the library's gather + attention, the
    plain version's eager time."""
    from paddle_tpu_torch.ops.paged_attention import (
        paged_flash_decode, paged_flash_decode_ref)

    ms = graph_ms(torch, paged_flash_decode, args, 50)
    call = time_ms(torch, paged_flash_decode, args, 200)
    plain = time_ms(torch, paged_flash_decode_ref, args, 20)
    lib = graph_ms(torch, library, args, 20)
    lib_call = time_ms(torch, library, args, 50)
    b_ms, b_by, nbytes, flops = bound_row
    log(f"timing[{gpu}] paged_flash_decode {label}: kernel {ms:.4f} ms "
        f"(graph; eager call {call:.4f} ms), plain {plain:.4f} ms, library "
        f"({lib_name}) {lib:.4f} ms "
        f"(graph; eager {lib_call:.4f} ms), bound {b_ms:.4f} ms by {b_by} "
        f"({nbytes} bytes, {flops:.0f} flops)")
    return dict(ms=ms, call_ms=call, plain_ms=plain, library_ms=lib,
                library_call_ms=lib_call, bound_ms=b_ms, bound_by=b_by)


def timing(torch, gpu):
    """Phase 5: kernel, plain and library times at the decode shapes
    (float32 q and pools)."""
    import torch.nn.functional as F

    def library(q, kp, vp, tab, mask):
        # yardstick only (never called by the port): gather the pages,
        # then PyTorch's fused attention with the boolean mask
        k = kp[tab.long()].permute(0, 2, 1, 3, 4).reshape(B, H, G * PAGE, HD)
        v = vp[tab.long()].permute(0, 2, 1, 3, 4).reshape(B, H, G * PAGE, HD)
        return F.scaled_dot_product_attention(q, k, v,
                                              attn_mask=mask[:, None])

    gen = torch.Generator().manual_seed(SEED + 1)
    rows = {}
    for T in (1, 5):
        q, pools, tab, mask, tab_raw = geometry(torch, T, torch.float32,
                                                gen, n_copies=4)
        args = [(q, kp, vp, tab, mask) for kp, vp in pools]
        rows[T] = time_paged(
            torch, gpu, f"f32 B={B} H={H} T={T} hd={HD} page={PAGE} G={G}",
            args, library, "gather+sdpa", bound(q, tab_raw, mask))
    return rows


# -- quantized serving --------------------------------------------------------
def quantize_pools(torch, kp, vp, qdt):
    """Quantize float pools as ``forward_paged`` writes them: one scale
    per stored token per head.  Returns (k, v, k_scale, v_scale)."""
    from paddle_tpu_torch.models.gpt import _quantize_kv

    P1, Hh, page, hd = kp.shape
    out = []
    for pool in (kp, vp):
        rows = pool.permute(0, 2, 1, 3).reshape(-1, Hh, hd)
        codes, sc = _quantize_kv(rows, qdt)
        out += [codes.reshape(P1, page, Hh, hd).permute(0, 2, 1, 3)
                .contiguous(),
                sc.reshape(P1, page, Hh).permute(0, 2, 1).contiguous()]
    return out[0], out[2], out[1], out[3]


def qmm_inputs(torch, mode, M, K, N, gen, n_copies=1):
    """Seeded operands of one quantized linear as the path makes them:
    activations quantized per tensor, the weight per output channel, the
    folded scale and a bias — ``(xq, wq, scale, bias)``, the kernel's
    arguments, then the float ``x`` and the ``weight_scale`` they came
    from.  ``n_copies`` distinct weights rotate a timing loop past the L2
    cache."""
    from paddle_tpu_torch.ops.quantized_matmul import quantize_activations
    from paddle_tpu_torch.slim.quantization import _quantize_weight

    x = torch.randn(M, K, generator=gen).to(DEVICE)
    xq, xs = quantize_activations(x, mode)
    bias = (0.02 * torch.randn(N, generator=gen)).to(DEVICE)
    out = []
    for _ in range(n_copies):
        w = (0.02 * torch.randn(K, N, generator=gen)).to(DEVICE)
        wq, ws = _quantize_weight(w, mode)
        out.append((xq, wq, (ws * xs).contiguous(), bias, x, ws))
    return out


def qmm_check(torch, mode, M, K, N, gen, label):
    """quantized_matmul against its plain version on seeded operands at
    one shape: int8 accumulator and output bit-equal, fp8 within rtol
    1e-4, atol 1e-4 x max|out|; the public wrapper too (quantize, fold,
    dispatch, cast).  Returns the largest abs error."""
    from paddle_tpu_torch.ops.quantized_matmul import (
        _matmul_kernel, _matmul_ref, quantized_linear, quantized_linear_ref)

    (xq, wq, scale, bias, x, ws), = qmm_inputs(torch, mode, M, K, N, gen)
    out = _matmul_kernel(xq, wq, scale, bias)
    ref = _matmul_ref(xq, wq, scale, bias)
    pub = quantized_linear(x, wq, ws, bias)
    pref = quantized_linear_ref(x, wq, ws, bias)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if mode == "int8":
        one, zero = torch.ones_like(scale), torch.zeros_like(bias)
        acc = _matmul_kernel(xq, wq, one, zero)
        acc0 = _matmul_ref(xq, wq, one, zero)
        assert torch.equal(acc, acc0), \
            f"int8 accumulator differs at {label} M={M}"
        assert torch.equal(out, ref) and torch.equal(pub, pref), \
            f"int8 output differs at {label} M={M}: {err}"
    else:
        tol = dict(rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
        torch.testing.assert_close(out, ref, **tol)
        torch.testing.assert_close(pub, pref, **tol)
        share = float(((out - ref).abs() / (
            tol["atol"] + tol["rtol"] * ref.abs())).max())
        log(f"kernel quantized_matmul fp8 {label} [{M}, {K}] @ "
            f"[{K}, {N}]: max_abs_err={err:.3e}, {share:.3f} of "
            f"the tolerance (rtol=1e-4, atol=1e-4 x max|out| = "
            f"{tol['atol']:.3e})")
    return err


def check_quantized_matmul(torch):
    """Phase Q1: the quantized_matmul kernel against its plain version at
    the path's shapes.  Returns the largest abs error per mode."""
    gen = torch.Generator().manual_seed(SEED + 5)
    errs = {}
    for mode in QUANT_MODES:
        worst = 0.0
        for name, (K, N) in QMM_KN.items():
            for M in QMM_M:
                worst = max(worst, qmm_check(torch, mode, M, K, N, gen,
                                             name))
        errs[mode] = worst
        log(f"kernel quantized_matmul {mode} at {list(QMM_KN.values())} x M "
            f"in {QMM_M}: max_abs_err={worst:.3e} vs plain ("
            + ("accumulator and output bit-equal" if mode == "int8" else
               "rtol=1e-4, atol=1e-4 x max|out|") + ") ok")
    return errs


def check_kernels_quantized(torch):
    """Phase Q2: paged_flash_decode over int8 / fp8 pools vs plain."""
    from paddle_tpu_torch.ops.paged_attention import (
        paged_flash_decode, paged_flash_decode_ref)
    gen = torch.Generator().manual_seed(SEED + 6)
    max_err = 0.0
    for mode, qdt in zip(QUANT_MODES, (torch.int8, torch.float8_e4m3fn)):
        for T in QUANT_T:
            q, pools, tab, mask, _ = geometry(torch, T, torch.float32, gen)
            k, v, ks, vs = quantize_pools(torch, *pools[0], qdt)
            out = paged_flash_decode(q, k, v, tab, mask, ks, vs)
            ref = paged_flash_decode_ref(q, k, v, tab, mask, ks, vs)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=2e-5)
            dead = ~mask.any(-1)
            assert int(dead.sum()) >= 1
            assert torch.all(out.permute(0, 2, 1, 3)[dead] == 0), \
                "fully-masked rows must be exactly 0"
            err = float((out - ref).abs().max())
            max_err = max(max_err, err)
            log(f"kernel paged_flash_decode {mode} pool, f32 q, T={T}: "
                f"max_abs_err={err:.3e} vs plain (rtol=1e-4, atol=2e-5) ok")
            if T in (1, 5):
                paged_edges(torch, (q, k, v, tab, mask, ks, vs),
                            dict(rtol=1e-4, atol=2e-5), f"{mode} pool T={T}")
    return max_err


def timing_quantized(torch, gpu):
    """Phase Q4: both kernels over quantized operands — kernel, plain and
    library times beside the bound; ``quantized_matmul`` at all four
    linears of the path x M in QMM_M, both modes, with the achieved bytes
    and operation rates."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.quantized_matmul import (_matmul_kernel,
                                                       _matmul_ref)

    def attn_library(q, k, v, tab, mask, ks, vs):
        # yardstick only: gather, dequantize, PyTorch's fused attention
        def view(pool, sc):
            x = pool[tab.long()].float() * sc[tab.long()][..., None]
            return x.permute(0, 2, 1, 3, 4).reshape(B, H, G * PAGE, HD)
        return F.scaled_dot_product_attention(q, view(k, ks), view(v, vs),
                                              attn_mask=mask[:, None])

    gen = torch.Generator().manual_seed(SEED + 7)
    rows = {}
    before = torch.cuda.memory_allocated()
    for mode, qdt in zip(QUANT_MODES, (torch.int8, torch.float8_e4m3fn)):
        for T in (1, 5):
            q, pools, tab, mask, tab_raw = geometry(torch, T, torch.float32,
                                                    gen, n_copies=6)
            args = []
            for kp, vp in pools:
                k, v, ks, vs = quantize_pools(torch, kp, vp, qdt)
                args.append((q, k, v, tab, mask, ks, vs))
            del pools
            rows[("paged", mode, T)] = time_paged(
                torch, gpu, f"{mode} pool f32 q B={B} H={H} T={T} hd={HD} "
                f"page={PAGE} G={G}", args, attn_library,
                "gather+dequantize+sdpa",
                bound(q, tab_raw, mask, quantized=True))

    def library_fn(mode, M):
        # one PyTorch call for the product alone (no epilogue); None where
        # it does not take the shape
        if mode == "int8":
            return (lambda xq, wq, s, b: torch._int_mm(xq, wq)) \
                if M > 16 else None
        one = torch.ones((), device=DEVICE)
        return lambda xq, wq, s, b: torch._scaled_mm(
            xq, wq, scale_a=one, scale_b=one, out_dtype=torch.float32)

    for mode in QUANT_MODES:
        for name in QMM_KN:
            K, N = QMM_KN[name]
            for M in QMM_M:
                args = [a[:4] for a in qmm_inputs(
                    torch, mode, M, K, N, gen,
                    n_copies=-(-64_000_000 // (K * N)))]
                # device time from a CUDA graph; the eager call, bounded
                # below by its Python, beside it
                ms = graph_ms(torch, _matmul_kernel, args, 100)
                call = time_ms(torch, _matmul_kernel, args, 200)
                plain = time_ms(torch, _matmul_ref, args, 20)
                lib, why = None, "none: torch._int_mm needs M > 16"
                fn = library_fn(mode, M)
                if fn is not None:
                    if mode == "fp8":  # _scaled_mm wants wq column-major
                        largs = [(xq, wq.t().contiguous().t(), s_, b_)
                                 for xq, wq, s_, b_ in args]
                    else:
                        largs = args
                    try:
                        lib = graph_ms(torch, fn, largs, 50)
                    except RuntimeError as e:  # the yardstick, not the port
                        why = f"none: {str(e).splitlines()[0][:120]}"
                    del largs
                nbytes = M * K + K * N + 8 * N + 4 * M * N
                ops = 2.0 * M * K * N
                t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / TENSOR_8BIT_OPS
                b_ms = max(t_b, t_o) * 1e3
                b_by = "bytes" if t_b >= t_o else "operations"
                lib_s = f"{lib:.4f} ms" if lib is not None else why
                log(f"timing[{gpu}] quantized_matmul {mode} {name} [{M}, "
                    f"{K}] @ [{K}, {N}]: kernel {ms:.4f} ms (graph; eager "
                    f"call {call:.4f} ms) = "
                    f"{nbytes / ms / 1e6:.1f} GB/s and {ops / ms / 1e9:.2f} "
                    f"TOP/s (bound: {HBM_BYTES_PER_S / 1e9:.0f} GB/s, "
                    f"{TENSOR_8BIT_OPS / 1e12:.0f} TOP/s), plain "
                    f"{plain:.4f} ms, library ("
                    f"{'_int_mm' if mode == 'int8' else '_scaled_mm'}, "
                    f"product only) {lib_s}, bound {b_ms:.5f} ms by {b_by} "
                    f"({nbytes} bytes, {ops:.4g} ops)")
                rows[("qmm", mode, name, M)] = dict(
                    ms=ms, call_ms=call, plain_ms=plain, library_ms=lib,
                    bound_ms=b_ms, bound_by=b_by)
                del args
    # the yardsticks' cuBLAS workspaces would otherwise stay allocated and
    # count in every later phase's peak device memory
    torch.cuda.synchronize()
    getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
    log(f"timing_quantized: device memory allocated {before} bytes "
        f"before, {torch.cuda.memory_allocated()} after")
    return rows


# -- the training path --------------------------------------------------------
# (name, dtype, rows, width[, s cotangent]): the two kernels' shapes on the
# training path; layernorm_residual's also at the long-context slice's 2 x
# 8192 rows (phase LT2), and whether its backward gets the s cotangent
# (pre-LN GPT: yes; post-LN BERT: y alone); softmax_cross_entropy's also
# at BERT's float32 logits under amp O1 (phase F2: the tied MLM decoder
# runs in float32)
LN_SHAPES = (("bert", "bfloat16", BERT_B * BERT_S, 768, False),
             ("gpt", "float32", GPT_B * GPT_S, 768, True),
             ("long", "bfloat16", 2 * 8192, 768, True))
SX_SHAPES = (("bert", "bfloat16", BERT_B * BERT_P, 30522),
             ("gpt", "float32", GPT_B * (GPT_S - 1), 50304),
             ("bert_o1", "float32", BERT_B * BERT_P, 30522))


def ln_inputs(torch, dtype, M, D, gen, n_copies=1):
    dt = getattr(torch, dtype)
    g = (1 + 0.1 * torch.randn(D, generator=gen)).to(DEVICE, dt)
    b = (0.1 * torch.randn(D, generator=gen)).to(DEVICE, dt)
    return [(torch.randn(M, D, generator=gen).to(DEVICE, dt),
             torch.randn(M, D, generator=gen).to(DEVICE, dt), g, b)
            for _ in range(n_copies)]


def sx_inputs(torch, dtype, M, V, gen, n_copies=1, out_of_range=False):
    dt = getattr(torch, dtype)
    out = []
    for _ in range(n_copies):
        lab = torch.randint(0, V, (M,), generator=gen)
        if out_of_range:
            lab[0], lab[1], lab[2] = 0, V - 1, -1
        out.append(((3 * torch.randn(M, V, generator=gen)).to(DEVICE, dt),
                    lab.to(DEVICE)))
    return out


def ln_bound(M, D, item):
    """Bytes: x, r read and s, y written once, weight and bias read once,
    mean and rstd written; operations: ~8 per element in float32."""
    nbytes = 4 * M * D * item + 2 * D * item + 8 * M
    ops = 8.0 * M * D
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def ln_bwd_bound(M, D, item, has_ds):
    """Bytes: s, dy (and ds_out) read and ds written once, mean and rstd
    read, weight read and dg, db written; operations: ~12 per element in
    float32."""
    nbytes = (3 + has_ds) * M * D * item + 8 * M + 3 * D * item
    ops = 12.0 * M * D
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def sx_bound(M, V, item):
    """Bytes: logits read once, int32 labels read, loss and lse written;
    operations: ~4 per logit (max, subtract, exp, add) in float32."""
    nbytes = M * V * item + 12 * M
    ops = 4.0 * M * V
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def ln_tol(dtype):
    """float32: the same arithmetic summed in another order; bf16 / float16:
    outputs rounded once from float32, one step of the dtype apart at most
    (bf16 2^-7 of the value, float16 2^-10: 2e-3 holds two float16 steps
    and fails a float16 output rounded through bf16)."""
    return {"float32": dict(rtol=1e-5, atol=1e-5),
            "float16": dict(rtol=2e-3, atol=2e-3)}.get(
                dtype, dict(rtol=2e-2, atol=2e-2))


def check_ln_bwd(torch, fl, s, mean, rstd, g, dy, ds_out, tol, design=None):
    """``layernorm_residual``'s backward kernel against ``_backward_ref``
    on the same card tensors: ds within ``tol``, dg and db scaled by their
    largest magnitude, a second call bit-equal, one count a call.  Returns
    ds's largest abs error."""
    before = fl.layernorm_residual.backward_launches
    got = fl._backward_kernel(s, mean, rstd, g, ds_out, dy, design=design)
    again = fl._backward_kernel(s, mean, rstd, g, ds_out, dy, design=design)
    want = fl._backward_ref(s, mean, rstd, g, ds_out, dy)
    torch.cuda.synchronize()
    assert fl.layernorm_residual.backward_launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "layernorm_residual backward: two calls differ"
    torch.testing.assert_close(got[0], want[0], **tol)
    for a, w in zip(got[1:], want[1:]):
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(a.float() / scale, w.float() / scale,
                                   **tol)
    return float((got[0].float() - want[0].float()).abs().max())


def check_ln(torch, fl, dtype, M, D, gen):
    """``layernorm_residual``'s kernels against their plain versions at
    [M, D]: the forward in the design the plan picks and in the first
    design (``s`` exact, ``y``, mean and rstd within tolerance); the
    backward kernel with and without the s cotangent, in the design the
    plan picks and in its element layout (``check_ln_bwd``); and the public
    wrapper's outputs and gradients against the plain autograd's.  Returns
    (y's, ds's largest abs error) of the planned designs."""
    tol = ln_tol(dtype)
    (x, r, g, b), = ln_inputs(torch, dtype, M, D, gen)
    fplan = fl._forward_plan(x.dtype, D, True)
    bplan = fl._backward_plan(x.dtype, D, True)
    s0, y0, mean0, rstd0 = fl._forward_ref(x, r, g, b, 1e-5)
    err = None
    for design in dict.fromkeys((None, "first")):
        s, y, mean, rstd = fl._forward_kernel(x, r, g, b, 1e-5,
                                              design=design)
        torch.cuda.synchronize()
        assert torch.equal(s, s0), ("layernorm_residual: s differs", design)
        torch.testing.assert_close(y, y0, **tol)
        torch.testing.assert_close(mean, mean0, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(rstd, rstd0, rtol=1e-5, atol=1e-5)
        e = float((y.float() - y0.float()).abs().max())
        err = e if err is None else err
        log(f"kernel layernorm_residual {dtype} [{M}, {D}] forward "
            f"{design or fplan}: s exact, y max_abs_err={e:.3e} vs plain "
            f"(rtol={tol['rtol']}, atol={tol['atol']}) ok")
    dy, ds = (torch.randn(M, D, generator=gen).to(DEVICE, y.dtype)
              for _ in range(2))
    s, y, mean, rstd = fl._forward_kernel(x, r, g, b, 1e-5)
    bwd_err = 0.0
    # a build without the backward kernel (tools/torch_kernel_ab.py) plans
    # "plain" everywhere: nothing to hold
    bwd_designs = (() if bplan == "plain" else dict.fromkeys((None,
                                                              "scalar")))
    for design in bwd_designs:
        for ds_out in (ds, None):
            e = check_ln_bwd(torch, fl, s, mean, rstd, g, dy, ds_out, tol,
                             design=design)
            if design is None:
                bwd_err = max(bwd_err, e)
            log(f"kernel layernorm_residual {dtype} [{M}, {D}] backward "
                f"{design or bplan}, "
                f"{'with' if ds_out is not None else 'without'} the s "
                f"cotangent: ds max_abs_err={e:.3e}, dg / db within "
                f"(rtol={tol['rtol']}, atol={tol['atol']}) of their largest "
                f"magnitude; two calls bit-equal; ok")
    outs, grads = [], []
    for fn in (fl.layernorm_residual, fl.layernorm_residual_ref):
        args = [t.clone().requires_grad_() for t in (x, r, g, b)]
        ss, yy = fn(*args)
        outs.append((ss.detach(), yy.detach()))
        grads.append(torch.autograd.grad(yy, args, dy))
    # the public wrapper's own outputs (reshape + dispatch) too
    (sw, yw), (sp, yp) = outs
    assert torch.equal(sw, sp), "layernorm_residual wrapper: s differs"
    torch.testing.assert_close(yw, yp, **tol)
    gerr = 0.0
    for a, w in zip(*grads):
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(a.float() / scale, w.float() / scale,
                                   **tol)
        gerr = max(gerr, float((a.float() - w.float()).abs().max()))
    log(f"kernel layernorm_residual {dtype} [{M}, {D}]: the wrapper's s "
        f"exact, y and grads (max_abs_err={gerr:.3e}) vs plain autograd ok")
    return err, bwd_err


def ln_copies(M, D, item):
    """Input copies a timing rotates through: x and r of all of them hold
    more than twice the 50 MB L2."""
    return max(2, -(-120_000_000 // (2 * M * D * item)))


def ln_library_bwd(torch, s, g, b, dy, ds_out):
    """The one PyTorch call that computes the same gradient:
    ``native_layer_norm_backward`` over ``s`` with the library's own saved
    statistics (plus the s cotangent where there is one)."""
    D = s.shape[-1]
    _, mean, rstd = torch.native_layer_norm(s, [D], g, b, 1e-5)

    def call(dy, ds_out):
        ds, dg, db = torch.ops.aten.native_layer_norm_backward(
            dy, s, [D], mean, rstd, g, b, [True, True, True])
        return (ds + ds_out if ds_out is not None else ds), dg, db
    return call, (dy, ds_out)


def time_ln(torch, fl, gpu, dtype, M, D, has_ds, gen):
    """``layernorm_residual``'s forward and backward at [M, D]: the
    kernels' device time from a CUDA graph (``graph_ms``) with the eager
    call beside it, the forward's first design, the plain versions and the
    library calls (``F.layer_norm(x + r)``; ``native_layer_norm_backward``
    plus the s cotangent's add where ``has_ds``) by the same graph method,
    inputs rotated past the L2, beside the bounds."""
    import torch.nn.functional as F

    item = torch.finfo(getattr(torch, dtype)).bits // 8
    args = ln_inputs(torch, dtype, M, D, gen, n_copies=ln_copies(M, D, item))
    fwd = lambda *a: fl._forward_kernel(*a, 1e-5)  # noqa: E731
    ms = graph_ms(torch, fwd, args, 100)
    eager = time_ms(torch, fwd, args, 100)
    first = graph_ms(torch, lambda *a: fl._forward_kernel(
        *a, 1e-5, design="first"), args, 100)
    plain = graph_ms(torch, lambda *a: fl._forward_ref(*a, 1e-5), args, 20)
    lib = graph_ms(torch, lambda x, r, g, b: F.layer_norm(
        x + r, (D,), g, b, 1e-5), args, 50)
    b_ms, b_by = ln_bound(M, D, item)
    bargs, largs = [], []
    for x, r, g, b in args:
        s, _, mean, rstd = fl._forward_kernel(x, r, g, b, 1e-5)
        dy = torch.randn(M, D, generator=gen).to(DEVICE, s.dtype)
        ds_out = (torch.randn(M, D, generator=gen).to(DEVICE, s.dtype)
                  if has_ds else None)
        bargs.append((s, mean, rstd, g, ds_out, dy))
        largs.append(ln_library_bwd(torch, s, g, b, dy, ds_out))
    del args
    bms = graph_ms(torch, fl._backward_kernel, bargs, 50)
    beager = time_ms(torch, fl._backward_kernel, bargs, 50)
    bplain = graph_ms(torch, fl._backward_ref, bargs, 10)
    # each copy's library call closes over its own s and statistics
    blib = graph_ms(torch, lambda i: largs[i][0](*largs[i][1]),
                    [(i,) for i in range(len(largs))], 50)
    bb_ms, bb_by = ln_bwd_bound(M, D, item, has_ds)
    log(f"timing[{gpu}] layernorm_residual {dtype} [{M}, {D}] forward "
        f"({fl._forward_plan(getattr(torch, dtype), D, True)}): device "
        f"{ms:.4f} ms ({100 * b_ms / ms:.0f}% of the bound; eager "
        f"{eager:.4f}), first design {first:.4f}, plain {plain:.4f}, library "
        f"(layer_norm(x + r)) {lib:.4f}, bound {b_ms:.4f} ms by {b_by}")
    log(f"timing[{gpu}] layernorm_residual {dtype} [{M}, {D}] backward "
        f"({fl._backward_plan(getattr(torch, dtype), D, True)}, "
        f"{'with' if has_ds else 'without'} the s cotangent): device "
        f"{bms:.4f} ms ({100 * bb_ms / bms:.0f}% of the bound; eager "
        f"{beager:.4f}), plain {bplain:.4f}, library "
        f"(native_layer_norm_backward{' + add' if has_ds else ''}) "
        f"{blib:.4f}, bound {bb_ms:.4f} ms by {bb_by}")
    return dict(ms=ms, eager_ms=eager, first_design_ms=first,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                backward=dict(ms=bms, eager_ms=beager, plain_ms=bplain,
                              library_ms=blib, bound_ms=bb_ms,
                              bound_by=bb_by, s_cotangent=has_ds))


def check_train_kernels(torch):
    """Phase 6: the training kernels against their plain versions at the
    path's shapes, forward and gradient."""
    from paddle_tpu_torch.ops import fused_layernorm as fl
    from paddle_tpu_torch.ops import fused_softmax_xent as sx

    gen = torch.Generator().manual_seed(SEED + 2)
    errs = {}
    for name, dtype, M, D, _ in LN_SHAPES:
        (errs[("layernorm_residual", name)],
         errs[("layernorm_residual_backward", name)]) = check_ln(
            torch, fl, dtype, M, D, gen)
    for name, dtype, M, V in SX_SHAPES:
        (x, lab), = sx_inputs(torch, dtype, M, V, gen, out_of_range=True)
        loss, lse = sx._forward_kernel(x, lab)
        loss0, lse0 = sx._forward_ref(x, lab)
        torch.cuda.synchronize()
        torch.testing.assert_close(loss, loss0, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(lse, lse0, rtol=1e-5, atol=1e-4)
        assert float(loss[2]) == float(lse[2]), "out-of-range label"
        g = torch.rand(M, generator=gen).to(DEVICE)
        outs, grads = [], []
        for fn in (sx.softmax_cross_entropy, sx.softmax_cross_entropy_ref):
            xx = x.clone().requires_grad_()
            ll = fn(xx, lab)
            outs.append(ll.detach())
            grads.append(torch.autograd.grad(ll, xx, g)[0].float())
        # the public wrapper's own loss (reshape + dispatch) too
        torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-4)
        gtol = (dict(rtol=1e-4, atol=1e-6) if dtype == "float32"
                else dict(rtol=1e-2, atol=1e-5))
        torch.testing.assert_close(grads[0], grads[1], **gtol)
        err = float((loss - loss0).abs().max())
        errs[("softmax_cross_entropy", name)] = err
        log(f"kernel softmax_cross_entropy {dtype} [{M}, {V}]: loss "
            f"max_abs_err={err:.3e}, lse max_abs_err="
            f"{float((lse - lse0).abs().max()):.3e}, grad max_abs_err="
            f"{float((grads[0] - grads[1]).abs().max()):.3e} vs plain "
            f"(loss/lse rtol=1e-5 atol=1e-4; grad rtol={gtol['rtol']} "
            f"atol={gtol['atol']}) ok")
    return errs


def bert_batch(vocab, B, S, P, seed=SEED):
    """Seeded MLM+NSP data, built as bench.py builds it."""
    import numpy as np

    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(B, S)).astype(np.int32)
    positions = np.stack([np.sort(rng.choice(S, P, replace=False))
                          for _ in range(B)]).astype(np.int32)
    inputs = [ids, (rng.uniform(size=(B, S)) < 0.5).astype(np.int32),
              np.ones((B, S), np.int32), positions]
    labels = [np.take_along_axis(ids, positions, axis=1),
              rng.randint(0, 2, size=(B, 1)).astype(np.int32)]
    return inputs, labels


def train_steps(torch, model, inputs, labels, warmup, steps, counters):
    """``warmup`` + ``steps`` ``train_batch`` calls; the counters (and
    ``layernorm_residual.backward_launches``) are zeroed just before the
    timed steps and read just after.  Returns (losses, seconds of the
    timed steps, launches per counter)."""
    losses = [model.train_batch(inputs, labels)[0] for _ in range(warmup)]
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
        if hasattr(c, "backward_launches"):  # layernorm_residual's
            c.backward_launches = 0
    t0 = time.monotonic()
    for _ in range(steps):
        losses.append(model.train_batch(inputs, labels)[0])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return losses, wall, [c.launches for c in counters]


def ln_backward_gate(layernorm_residual, ln, tag, kernel=True):
    """The backward kernel ran once for every forward launch of the timed
    steps (``kernel=False``: a build without it, whose backward is the
    plain arithmetic: none).  Returns the backward count."""
    lnb = layernorm_residual.backward_launches
    want = ln if kernel else 0
    log(f"{tag}: layernorm_residual backward launches {lnb} (= {want}: "
        f"{lnb == want})")
    assert lnb == want, (tag, lnb, want)
    return lnb


def train_bert(torch, gpu, ln_backward_kernel=True):
    """Phase 7: BERT-base bf16 pretraining through Model.train_batch
    (``ln_backward_kernel=False``: the layernorm backward is expected to
    be the plain arithmetic, as behind a build that lacks the kernel)."""
    import math

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import BertForPretraining, bert_base
    from paddle_tpu_torch.ops import layernorm_residual, softmax_cross_entropy

    cfg = bert_base()
    t0 = time.monotonic()
    ptt.seed(SEED)
    net = BertForPretraining(cfg, device=DEVICE).astype("bfloat16")
    opt = ptt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                              multi_precision=True)
    model = ptt.Model(net, ["input_ids", "token_type_ids", "attention_mask",
                            "masked_positions"],
                      ["mlm_labels", "nsp_labels"]).prepare(
        optimizer=opt, loss=net.loss)
    inputs, labels = bert_batch(cfg.vocab_size, BERT_B, BERT_S, BERT_P)
    log(f"train[bert]: bert_base bf16 params="
        f"{sum(p.numel() for p in net.parameters())} layers={cfg.num_layers}"
        f" batch {BERT_B}x{BERT_S}, {BERT_P} masked, built in "
        f"{time.monotonic() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    losses, wall, (ln, sx) = train_steps(
        torch, model, inputs, labels, BERT_WARMUP, BERT_STEPS,
        (layernorm_residual, softmax_cross_entropy))
    peak = torch.cuda.max_memory_allocated()
    log(f"train[bert]: losses {[round(x, 4) for x in losses]}")
    log(f"train[bert]: kernel launches over {BERT_STEPS} steps: "
        f"layernorm_residual {ln} (= 24 x {BERT_STEPS}: "
        f"{ln == 24 * BERT_STEPS}), softmax_cross_entropy {sx} (= "
        f"{BERT_STEPS}: {sx == BERT_STEPS})")
    assert ln == 2 * cfg.num_layers * BERT_STEPS, ln
    lnb = ln_backward_gate(layernorm_residual, ln, "train[bert]",
                           ln_backward_kernel)
    assert sx == BERT_STEPS, sx
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    sd = opt.state_dict()
    masters = [v for k, v in sd.items() if k.endswith(".master")]
    assert len(masters) == len(list(net.parameters())) and all(
        m.dtype == torch.float32 for m in masters)
    sps = BERT_B * BERT_STEPS / wall
    log(f"train[bert][{gpu}]: {BERT_STEPS} steps in {wall:.3f}s = "
        f"{wall / BERT_STEPS * 1e3:.1f} ms/step, {sps:.1f} seq/s, peak "
        f"device memory {peak / 2**20:.0f} MiB, {len(masters)} float32 "
        f"master slots")
    del model, opt, net
    return {"launches": {"layernorm_residual": ln,
                         "layernorm_residual_backward": lnb,
                         "softmax_cross_entropy": sx},
            "seq_per_s": sps, "step_ms": wall / BERT_STEPS * 1e3,
            "peak_bytes": peak, "first_loss": losses[0],
            "last_loss": losses[-1]}


def train_gpt(torch, gpu):
    """Phase 8: GPT-small f32 training through Model.train_batch."""
    import math

    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_small
    from paddle_tpu_torch.ops import layernorm_residual, softmax_cross_entropy

    cfg = gpt_small()
    ptt.seed(SEED)
    net = GPTForCausalLM(cfg, device=DEVICE)
    opt = ptt.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                              multi_precision=True)
    model = ptt.Model(net).prepare(optimizer=opt, loss=net.loss)
    ids = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, size=(GPT_B, GPT_S)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    losses, wall, (ln, sx) = train_steps(
        torch, model, [ids], [ids], GPT_WARMUP, GPT_STEPS,
        (layernorm_residual, softmax_cross_entropy))
    peak = torch.cuda.max_memory_allocated()
    log(f"train[gpt]: gpt_small f32 dropout {cfg.dropout}, batch "
        f"{GPT_B}x{GPT_S}, losses {[round(x, 4) for x in losses]}; "
        f"launches over {GPT_STEPS} steps: layernorm_residual {ln}, "
        f"softmax_cross_entropy {sx}")
    assert ln == cfg.num_layers * GPT_STEPS, ln
    ln_backward_gate(layernorm_residual, ln, "train[gpt]")
    assert sx == GPT_STEPS, sx
    assert all(math.isfinite(x) for x in losses), losses
    tps = GPT_B * GPT_S * GPT_STEPS / wall
    log(f"train[gpt][{gpu}]: {GPT_STEPS} steps in {wall:.3f}s = "
        f"{wall / GPT_STEPS * 1e3:.1f} ms/step, {tps:.0f} tokens/s, peak "
        f"device memory {peak / 2**20:.0f} MiB")
    del model, opt, net
    return {"launches": {"layernorm_residual": ln,
                         "softmax_cross_entropy": sx},
            "tokens_per_s": tps, "step_ms": wall / GPT_STEPS * 1e3,
            "peak_bytes": peak}


def card_vs_cpu(torch):
    """Phase 9: two BERT-base f32 train steps on the card (kernels) and
    on the CPU (plain versions) from one seeded init."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import BertForPretraining, bert_base

    cfg = bert_base(dropout=0.0)
    inputs, labels = bert_batch(cfg.vocab_size, PARITY_B, BERT_S, BERT_P,
                                seed=SEED + 3)
    losses = {}
    for dev in (DEVICE, "cpu"):
        net = BertForPretraining(cfg, device=dev,
                                 generator=torch.Generator().manual_seed(SEED))
        opt = ptt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                  multi_precision=True)
        model = ptt.Model(net, [0] * 4, [0] * 2).prepare(optimizer=opt,
                                                         loss=net.loss)
        losses[dev] = [model.train_batch(inputs, labels)[0]
                       for _ in range(2)]
    log(f"parity: bert_base f32 batch {PARITY_B}x{BERT_S}, 2 train_batch "
        f"steps: card {losses[DEVICE]} vs cpu {losses['cpu']}")
    for a, b in zip(losses[DEVICE], losses["cpu"]):
        assert abs(a - b) <= 1e-4 * abs(b), (a, b)
    return losses


def timing_train(torch, gpu):
    """Phase 10: kernel, plain and library times of the two training
    kernels at both path shapes."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_layernorm as fl
    from paddle_tpu_torch.ops import fused_softmax_xent as sx

    gen = torch.Generator().manual_seed(SEED + 4)
    rows = {}
    with torch.no_grad():
        for name, dtype, M, D, has_ds in LN_SHAPES:
            rows[("layernorm_residual", name)] = time_ln(
                torch, fl, gpu, dtype, M, D, has_ds, gen)
        for name, dtype, M, V in SX_SHAPES:
            args = sx_inputs(torch, dtype, M, V, gen, n_copies=2)
            ms = time_ms(torch, sx._forward_kernel, args, 50)
            plain = time_ms(torch, sx._forward_ref, args, 10)
            lib = time_ms(torch, lambda x, lab: F.cross_entropy(
                x, lab, reduction="none"), args, 20)
            b_ms, b_by = sx_bound(M, V, args[0][0].element_size())
            rows[("softmax_cross_entropy", name)] = dict(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by)
            log(f"timing[{gpu}] softmax_cross_entropy {dtype} [{M}, {V}]: "
                f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
                f"(cross_entropy) {lib:.4f} ms, bound {b_ms:.4f} ms by "
                f"{b_by}")
    return rows


# -- ResNet-50 training (bench.py config 2) -----------------------------------
# (layer, M, K, N): the conv3 tail of each stage at batch 128, 224 x 224
RESNET_B, RESNET_HW = 128, 224
RESNET_TAILS = (("layer1", 401408, 64, 256), ("layer2", 100352, 128, 512),
                ("layer3", 25088, 256, 1024), ("layer4", 6272, 512, 2048))
RESNET_BLOCKS = 16             # bottleneck blocks of ResNet-50: 3 + 4 + 6 + 3
RESNET_WARMUP, RESNET_STEPS = 3, 10
RESNET_PARITY = dict(B=4, HW=64, steps=3)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core rate
TIMING_RUNS = 3


def resnet_tail_inputs(torch, dtype, M, K, N, gen, residual=True):
    """Seeded operands of one conv3 tail: x [M, K] (the bn2 -> relu
    output, so non-negative), w [K, N] ~ N(0, 2 / K), gamma, beta, the
    residual [M, N]."""
    dt = getattr(torch, dtype)
    x = torch.randn(M, K, generator=gen).relu_().to(DEVICE, dt)
    w = (torch.randn(K, N, generator=gen) * (2.0 / K) ** 0.5).to(DEVICE, dt)
    gamma = (1 + 0.1 * torch.randn(N, generator=gen)).to(DEVICE, dt)
    beta = (0.1 * torch.randn(N, generator=gen)).to(DEVICE, dt)
    res = (torch.randn(M, N, generator=gen).to(DEVICE, dt) if residual
           else None)
    return x, w, gamma, beta, res


def stats_tolerance(torch, y, y0, s, s0, q, q0, yf_abs, dtype):
    """Kernel 7 against its plain version.  y: within one bf16 ulp
    (rtol 2**-7; the f32 sums differ in order, so a value near a rounding
    boundary may round the other way) or rtol 1e-5 in float32, atol 1e-5 x
    max|y|.  Column sums: |s - s0| <= 3e-5 x sum|y| of the column (the
    float32 summation-order bound at these M), |q - q0| <= 3e-5 x q0.
    Returns the largest abs error of y and the scaled errors of s, q."""
    top = float(y0.float().abs().max())
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(y.float(), y0.float(), rtol=rtol,
                               atol=1e-5 * top)
    s_err = float(((s - s0).abs() / yf_abs.clamp_min(1e-30)).max())
    q_err = float(((q - q0).abs() / q0.clamp_min(1e-30)).max())
    assert s_err <= 3e-5 and q_err <= 3e-5, (s_err, q_err)
    return float((y.float() - y0.float()).abs().max()), s_err, q_err


def check_stats_design(torch, fcb, x, w, dtype, label, design=None,
                       ref=None):
    """Kernel 7 in one design against its plain version: two calls
    bit-equal, the tolerances of :func:`stats_tolerance`.  Returns (y, s,
    q) and the errors."""
    y, s, q = fcb._stats_kernel(x, w, design=design)
    y2, s2, q2 = fcb._stats_kernel(x, w, design=design)
    y0, s0, q0 = ref if ref is not None else fcb.conv1x1_bn_stats_ref(x, w)
    yf_abs = (x.float() @ w.float()).abs().sum(0)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(s, s2) \
        and torch.equal(q, q2), f"conv1x1_bn_stats not deterministic at " \
                                f"{label}"
    return (y, s, q), stats_tolerance(torch, y, y0, s, s0, q, q0, yf_abs,
                                      dtype)


def check_resnet_kernels(torch):
    """Phase R1: conv1x1_bn_stats and bn_apply_relu against their plain
    versions in both designs of each.  The Hopper designs at the four conv3
    shapes (bf16; kernel 7 with w as ResNet passes it, the .t() view of a
    contiguous [N, K] weight read K-major, and a contiguous [K, N] read
    MN-major: bit-equal) and at 1000 x 64 x 136; the first designs forced
    at the conv3 shapes and picked by the wrappers at layer3's float32
    shape and the ragged ones (M = 77, N = 196; K = 100, N = 130: the
    unvectorized loads and stores; M = 77, N = 200 takes the Hopper stats
    design).  Kernel 7 twice for bit-identical results; kernel 8 bit-equal
    to its plain version with and without the residual."""
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fcb

    gen = torch.Generator().manual_seed(SEED + 8)
    cases = [(name, "bfloat16", M, K, N) for name, M, K, N in RESNET_TAILS]
    cases += [("edge", "bfloat16", 1000, 64, 136),
              ("layer3", "float32", 25088, 256, 1024),
              ("ragged", "bfloat16", 77, 64, 200),
              ("ragged", "float32", 77, 64, 200),
              ("ragged N", "bfloat16", 77, 64, 196),
              ("ragged K, N", "bfloat16", 300, 100, 130),
              ("ragged K, N", "float32", 300, 100, 130)]
    errs = {}
    for name, dtype, M, K, N in cases:
        x, w, gamma, beta, res = resnet_tail_inputs(torch, dtype, M, K, N,
                                                    gen)
        wk = w.t().contiguous().t()  # ResNet's conv3 weight: [N, K] storage
        ref = fcb.conv1x1_bn_stats_ref(x, w)
        runs = [(wk, None)]
        if fcb._stats_plan(x, wk)[0] == "wgmma":  # also MN-major, and the
            runs += [(w, None)]                    # first design forced at
            if name.startswith("layer"):           # the conv3 shapes
                runs += [(w, "first")]
        got = {}
        for ww, design in runs:
            plan, layout = fcb._stats_plan(x, ww)
            served = design or plan
            label = (f"{served} (w {layout})" if served == "wgmma"
                     else "first design")
            if served == "wgmma":
                label += f", {fcb._stats_tile(N)}-column tiles"
            (y, s, q), (y_err, s_err, q_err) = check_stats_design(
                torch, fcb, x, ww, dtype, f"{name} {dtype} {label}", design,
                ref)
            got[(served, layout)] = (y, s, q)
            errs[(name, dtype, served)] = y_err
            log(f"kernel conv1x1_bn_stats {dtype} {name} [{M}, {K}] @ [{K}, "
                f"{N}] {label}: deterministic; y max_abs_err={y_err:.3e} "
                f"(rtol {2.0 ** -7 if dtype == 'bfloat16' else 1e-5:g}, atol "
                f"1e-5 x max|y|), sum err {s_err:.2e} x sum|y|, sumsq err "
                f"{q_err:.2e} x sumsq (<= 3e-5)")
        if ("wgmma", "k-major") in got and ("wgmma", "mn-major") in got:
            assert all(torch.equal(a, b) for a, b in zip(
                got[("wgmma", "k-major")], got[("wgmma", "mn-major")])), \
                f"w layouts differ at {name}"
            log(f"kernel conv1x1_bn_stats {dtype} {name}: w K-major and "
                f"MN-major bit-equal; ok")
        y, s, q = next(iter(got.values()))
        mean, var, inv, scale, shift = fcb._fold(s, q, M, gamma, beta,
                                                 1e-5, y.dtype)
        vec = all(t.data_ptr() % 16 == 0 for t in (y, res))
        plan = fcb._apply_plan(y.dtype, N, vec)
        for design in ([None, "first"] if plan == "resident" else [None]):
            for r in (res, None):
                out = fcb._apply_kernel(y, scale, shift, r, design=design)
                out0 = fcb.bn_apply_relu_ref(y, scale, shift, r)
                torch.cuda.synchronize()
                assert torch.equal(out, out0), (
                    f"bn_apply_relu ({design or plan}) differs from plain at "
                    f"{name} {dtype} residual={r is not None}: "
                    f"{float((out.float() - out0.float()).abs().max())}")
            served = "first design" if (design or plan) == "first" \
                else "resident"
            log(f"kernel bn_apply_relu {dtype} {name} [{M}, {N}] {served}: "
                f"bit-equal with and without the residual; ok")
        del x, w, wk, res, y, ref, got
    return errs


def check_resnet_tail_grads(torch):
    """Phase R2: the fused tail (autograd.Function: kernels forward,
    closed-form backward) against autograd through the plain version at
    layer3's shape, float32 and bf16: the output, both running stats, dx,
    dw, dgamma, dbeta and dresidual (bf16: the cotangent zeroed where the
    two ReLU masks differ, at most 1e-4 of the entries)."""
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fcb

    _, M, K, N = RESNET_TAILS[2]
    gen = torch.Generator().manual_seed(SEED + 9)
    worst = {}
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        ins = resnet_tail_inputs(torch, dtype, M, K, N, gen)
        dout = torch.randn(M, N, generator=gen).to(DEVICE, ins[0].dtype)
        rm0 = (0.1 * torch.randn(N, generator=gen)).to(DEVICE)
        rv0 = (1 + 0.1 * torch.rand(N, generator=gen)).to(DEVICE)
        runs = []
        for fn in (fcb.conv1x1_bn_relu, fcb.conv1x1_bn_relu_ref):
            args = [t.clone().requires_grad_() for t in ins]
            out, rm, rv = fn(*args[:4], residual=args[4], running_mean=rm0,
                             running_var=rv0)
            runs.append((out, rm, rv, args))
        # bf16: the two forwards round y apart by an ulp here and there, so
        # a few outputs sit on opposite sides of 0 and their ReLU masks
        # differ; the flips are counted and the cotangent is zeroed there,
        # so no gradient sees them
        agree = (runs[0][0] > 0) == (runs[1][0] > 0)
        flips = int((~agree).sum())
        assert flips <= 1e-4 * agree.numel(), f"{flips} ReLU-mask flips"
        got = [[out.detach(), rm, rv,
                *torch.autograd.grad(out, args, dout * agree)]
               for out, rm, rv, args in runs]
        del runs
        torch.cuda.synchronize()
        names = ("out", "running_mean", "running_var", "dx", "dw", "dgamma",
                 "dbeta", "dresidual")
        errs = []
        for nm, a, b in zip(names, *got):
            a, b = a.float(), b.float()
            scale = max(float(b.abs().max()), 1e-30)
            err = float((a - b).abs().max()) / scale
            assert err <= tol, f"fused tail {dtype} {nm}: {err:.3e} > {tol}"
            errs.append(f"{nm} {err:.1e}")
        errs.append(f"{flips} ReLU-mask flips")
        worst[dtype] = errs
        log(f"tail grads {dtype} [{M}, {K}] @ [{K}, {N}]: fused vs plain "
            f"autograd, max|diff| / max|plain| (<= {tol:g}): "
            + ", ".join(errs) + " ok")
    return worst


def resnet_model(torch, dtype, device, generator=None, num_classes=1000):
    import paddle_tpu_torch as ptt

    net = ptt.vision.models.resnet50(
        data_format="NHWC", stem_space_to_depth=True,
        num_classes=num_classes, device=device, generator=generator)
    return net.astype(dtype)


def resnet_trainer(torch, net, lr=0.1):
    """bench.py config 2's optimizer and loss around ``net``."""
    import paddle_tpu_torch as ptt

    opt = ptt.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                 multi_precision=True, weight_decay=1e-4)
    xent = ptt.nn.CrossEntropyLoss()
    return ptt.Model(net, inputs=1, labels=1).prepare(
        optimizer=opt, loss=lambda logits, y: xent(logits.float(), y))


def train_resnet(torch, gpu):
    """Phase R3: bench.py's config 2 through Model.train_batch: ResNet-50
    NHWC, space-to-depth stem, bf16, batch 128 at 224 x 224,
    Momentum(0.1, 0.9, multi_precision, weight_decay 1e-4)."""
    import math

    import numpy as np

    from paddle_tpu_torch.ops import bn_apply_relu, conv1x1_bn_stats

    t0 = time.monotonic()
    net = resnet_model(torch, "bfloat16", DEVICE,
                       torch.Generator().manual_seed(SEED))
    model = resnet_trainer(torch, net)
    rng = np.random.RandomState(SEED)
    images = torch.from_numpy(rng.uniform(
        -1, 1, (RESNET_B, RESNET_HW, RESNET_HW, 3)).astype(np.float32)).to(
        DEVICE, torch.bfloat16)
    labels = torch.from_numpy(rng.randint(0, 1000, (RESNET_B, 1)).astype(
        np.int32)).to(DEVICE)
    bn3 = {n: b.clone() for n, b in net.named_buffers() if ".bn3." in n}
    log(f"train[resnet50]: NHWC s2d-stem bf16 params="
        f"{sum(p.numel() for p in net.parameters())} batch {RESNET_B}x"
        f"{RESNET_HW}x{RESNET_HW}, {len(bn3)} bn3 buffers, built in "
        f"{time.monotonic() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, wall, (k7, k8) = train_steps(
        torch, model, [images], [labels], RESNET_WARMUP, RESNET_STEPS,
        (conv1x1_bn_stats, bn_apply_relu))
    peak = torch.cuda.max_memory_allocated()
    want = RESNET_BLOCKS * RESNET_STEPS
    log(f"train[resnet50]: losses {[round(x, 4) for x in losses]}")
    log(f"train[resnet50]: kernel launches over {RESNET_STEPS} steps: "
        f"conv1x1_bn_stats {k7}, bn_apply_relu {k8} (= {RESNET_BLOCKS} x "
        f"{RESNET_STEPS}: {k7 == want and k8 == want})")
    assert k7 == want and k8 == want, (k7, k8, want)
    assert all(math.isfinite(x) for x in losses), losses
    for n, b in net.named_buffers():
        if n in bn3:
            assert b.dtype == torch.bfloat16, (n, b.dtype)
            assert not torch.equal(b, bn3[n]), f"{n} did not change"
    ips = RESNET_B * RESNET_STEPS / wall
    log(f"train[resnet50][{gpu}]: {RESNET_STEPS} steps in {wall:.3f}s = "
        f"{wall / RESNET_STEPS * 1e3:.2f} ms/step, {ips:.1f} img/s, peak "
        f"device memory {peak / 2**20:.0f} MiB; every bn3 buffer moved and "
        f"is bfloat16")
    del model, net, images
    return {"launches": {"conv1x1_bn_stats": k7, "bn_apply_relu": k8},
            "img_per_s": ips, "step_ms": wall / RESNET_STEPS * 1e3,
            "peak_bytes": peak}


def resnet_card_vs_cpu(torch):
    """Phase R4: ResNet-50 float32 at 64 x 64, batch 4, parameters and
    buffers bridged from one seeded CPU model to the card; 3 train_batch
    steps of config 2's optimizer on each (the card through the fused tail
    and its float32 kernels, 16 launches a step; the CPU through the plain
    tail).  Gates: the step-1 loss (the forward) at rtol 1e-4; the step-1
    update (lr x (gradient + decay), all parameters as one vector) within
    10% in L2 of the CPU's; every loss finite.  The float32 gradient of
    this network at initialization is ill-conditioned — two float32 runs
    on the CPU whose inputs differ by 1e-7 differ by up to 50% in a tensor,
    and the CPU's float32 gradient sits 3.6% (L2) from float64's — so the
    losses of steps 2-3 are printed, not held to 1e-4."""
    import math

    import numpy as np

    from paddle_tpu_torch.bridge import load_jax_params
    from paddle_tpu_torch.ops import bn_apply_relu, conv1x1_bn_stats

    B, HW, steps = (RESNET_PARITY[k] for k in ("B", "HW", "steps"))
    rng = np.random.RandomState(SEED + 10)
    images = rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32)
    labels = rng.randint(0, 1000, (B, 1)).astype(np.int32)
    cpu_net = resnet_model(torch, "float32", "cpu",
                           torch.Generator().manual_seed(SEED))
    card_net = resnet_model(torch, "float32", DEVICE)
    load_jax_params(card_net,
                    {k: v.detach().numpy()
                     for k, v in cpu_net.named_parameters()},
                    {k: v.numpy() for k, v in cpu_net.named_buffers()})
    losses, updates = {}, {}
    for dev, net in ((DEVICE, card_net), ("cpu", cpu_net)):
        model = resnet_trainer(torch, net)
        conv1x1_bn_stats.launches = bn_apply_relu.launches = 0
        before = torch.cat([p.detach().flatten().cpu()
                            for p in net.parameters()])
        losses[dev] = [model.train_batch([images], [labels])[0]]
        updates[dev] = torch.cat([p.detach().flatten().cpu()
                                  for p in net.parameters()]) - before
        losses[dev] += [model.train_batch([images], [labels])[0]
                        for _ in range(steps - 1)]
        launches = (conv1x1_bn_stats.launches, bn_apply_relu.launches)
        want = RESNET_BLOCKS * steps if dev == DEVICE else 0
        assert launches == (want, want), (dev, launches)
    rel = float((updates[DEVICE] - updates["cpu"]).norm()
                / updates["cpu"].norm())
    log(f"parity: resnet50 f32 {B}x{HW}x{HW}, {steps} train_batch steps: "
        f"card {losses[DEVICE]} (fused tail, {RESNET_BLOCKS} launches a "
        f"step) vs cpu {losses['cpu']} (plain tail); step-1 loss rel diff "
        f"{abs(losses[DEVICE][0] - losses['cpu'][0]) / losses['cpu'][0]:.2e}"
        f" (<= 1e-4), step-1 update rel L2 diff {rel:.2e} (<= 0.1)")
    assert abs(losses[DEVICE][0] - losses["cpu"][0]) \
        <= 1e-4 * abs(losses["cpu"][0]), losses
    assert rel <= 0.1, rel
    assert all(math.isfinite(x) for v in losses.values() for x in v), losses
    return losses, rel


def runs_ms(torch, fn, args, iters):
    """Median, min and max ms per call over TIMING_RUNS runs of
    :func:`time_ms`."""
    vals = sorted(time_ms(torch, fn, args, iters) for _ in range(TIMING_RUNS))
    return vals[len(vals) // 2], vals[0], vals[-1]


def graph_runs_ms(torch, fn, args, iters):
    """Median, min and max device ms per call over TIMING_RUNS runs of
    :func:`graph_ms`."""
    vals = sorted(graph_ms(torch, fn, args, iters)
                  for _ in range(TIMING_RUNS))
    return vals[len(vals) // 2], vals[0], vals[-1]


def _spread(t):
    return f"{t[0]:.4f} ({t[1]:.4f}-{t[2]:.4f})"


def timing_resnet(torch, gpu):
    """Phase R5: both kernels at the four conv3 shapes (bf16), w as ResNet
    passes it: the Hopper design and the first design (device time from a
    CUDA graph of the calls, the eager call beside it), the plain version
    and the library call (``torch.mm``, the product alone), median
    (min-max) of 3 runs, inputs rotated past the 50 MB L2, beside the
    bound.  ``ms`` is the Hopper design's device time: at layers 3-4 the
    eager call is bounded by the wrapper's Python."""
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fcb

    gen = torch.Generator().manual_seed(SEED + 11)
    rows = {}
    with torch.no_grad():
        for name, M, K, N in RESNET_TAILS:
            per_call = 2 * (M * K + K * N + M * N)
            n_copies = max(2, -(-120_000_000 // per_call))
            ins = [resnet_tail_inputs(torch, "bfloat16", M, K, N, gen)
                   for _ in range(n_copies)]
            k7_args = [(x, w.t().contiguous().t()) for x, w, _, _, _ in ins]
            iters = max(10, min(200, int(4e10 // (M * N))))

            # the first design and the library on a contiguous [K, N] w (the
            # first design would copy ResNet's .t() view first)
            mm_args = [(x, w) for x, w, _, _, _ in ins]

            def first7(x, w):
                return fcb._stats_kernel(x, w, design="first")
            ms = graph_runs_ms(torch, fcb._stats_kernel, k7_args, iters)
            eager = runs_ms(torch, fcb._stats_kernel, k7_args, iters)
            first = graph_runs_ms(torch, first7, mm_args, iters)
            first_eager = runs_ms(torch, first7, mm_args, iters)
            plain = runs_ms(torch, fcb.conv1x1_bn_stats_ref, k7_args,
                            max(3, iters // 10))
            lib = graph_runs_ms(torch, torch.mm, mm_args, iters)
            lib_eager = runs_ms(torch, torch.mm, mm_args, iters)
            nbytes = 2 * M * K + 2 * K * N + 2 * M * N + 8 * N
            t_b, t_o = nbytes / HBM_BYTES_PER_S, 2.0 * M * K * N / BF16_FLOPS
            rows[("conv1x1_bn_stats", name)] = dict(
                ms=ms[0], plain_ms=plain[0], library_ms=lib[0],
                bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations",
                eager_ms=eager[0], first_design_ms=first[0],
                first_design_eager_ms=first_eager[0],
                library_eager_ms=lib_eager[0])
            log(f"timing[{gpu}] conv1x1_bn_stats bf16 {name} [{M}, {K}] @ "
                f"[{K}, {N}] (w K-major, {fcb._stats_tile(N)}-column tiles): "
                f"kernel {_spread(ms)} ms device time (eager "
                f"{_spread(eager)}), first design on a contiguous w "
                f"{_spread(first)} (eager "
                f"{_spread(first_eager)}), plain {_spread(plain)} ms, "
                f"library (torch.mm, product only) {_spread(lib)} (eager "
                f"{_spread(lib_eager)}) ms: kernel / torch.mm = "
                f"{ms[0] / lib[0]:.2f}; bound {max(t_b, t_o) * 1e3:.4f} ms "
                f"by {'bytes' if t_b >= t_o else 'operations'} ({nbytes} "
                f"bytes, {2 * M * K * N} flops)")
            k8_args = []
            for x, w, gamma, beta, res in ins:
                y, s, q = fcb._stats_kernel(x, w)
                _, _, _, scale, shift = fcb._fold(s, q, M, gamma, beta, 1e-5,
                                                  y.dtype)
                k8_args.append((y, scale, shift, res))
            del ins, k7_args, mm_args

            def first8(*a):
                return fcb._apply_kernel(*a, design="first")
            ms = graph_runs_ms(torch, fcb._apply_kernel, k8_args, iters)
            eager = runs_ms(torch, fcb._apply_kernel, k8_args, iters)
            first = graph_runs_ms(torch, first8, k8_args, iters)
            first_eager = runs_ms(torch, first8, k8_args, iters)
            plain = runs_ms(torch, fcb.bn_apply_relu_ref, k8_args,
                            max(3, iters // 10))
            nbytes = 6 * M * N + 8 * N
            t_b, t_o = nbytes / HBM_BYTES_PER_S, 4.0 * M * N / FP32_FLOPS
            rows[("bn_apply_relu", name)] = dict(
                ms=ms[0], plain_ms=plain[0], library_ms=None,
                bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations",
                eager_ms=eager[0], first_design_ms=first[0],
                first_design_eager_ms=first_eager[0])
            log(f"timing[{gpu}] bn_apply_relu bf16 {name} [{M}, {N}] + "
                f"residual: kernel {_spread(ms)} ms device time (eager "
                f"{_spread(eager)}), first design {_spread(first)} (eager "
                f"{_spread(first_eager)}), plain {_spread(plain)} ms, "
                f"library none (no single PyTorch call); bound "
                f"{max(t_b, t_o) * 1e3:.4f} ms by "
                f"{'bytes' if t_b >= t_o else 'operations'} ({nbytes} bytes):"
                f" {max(t_b, t_o) * 1e3 / ms[0]:.0%} of it")
            del k8_args
            gc.collect()
            torch.cuda.empty_cache()
    return rows


# -- long-context GPT inference (flash attention) -----------------------------
# the slice: gpt_small width and depth at 2 x 8192 in bf16 through
# eval_batch / predict_batch; bench.py:397-433's op shape (B, H, S, hd)
LC_B, LC_S = 2, 8192
LC_EVALS, LC_PREDICTS = 2, 1
LC_PARITY = dict(B=1, S=4096, layers=2)
BENCH_OP = (1, 8, 32768, 128)
# (S, K, causal, q_position_offset): ragged S and K, K > S, an offset that
# is not block-aligned, a negative one (rows with no valid key); S below
# the bf16 kernel's 128-row q tile, and one row past it
FLASH_CASES = ((1000, 1000, True, 0), (777, 1290, False, 0),
               (700, 1300, True, 517), (513, 400, True, -130),
               (127, 127, True, 0), (129, 257, True, 128))
# the kernel against its plain version: float32 sums in another order;
# bf16 rounds P to bf16 for the P.V product (the plain version keeps it
# float32) and the output to bf16.  A long row averages thousands of values,
# so its outputs are small (~0.02 at S = 8192): bf16 is held element-wise
# to rtol 2e-2 (one output ulp) plus 2e-2 of the reference row's RMS (P's
# rounding, ~0.007 of it in an emulation of the kernel's arithmetic), not
# to a fixed atol that large rows would hide a fault under
# LT1's small cases for the backward kernels (S, K, causal, offset): S = K
# (ragged against the 128-row / 128-key bf16 blocks and the 64-row tiles),
# S != K both ways, offsets 0, 37, K - S and -64 (its first 64 rows see no
# key: their dq must be exactly 0); S one row short of and one row past
# the bf16 blocks
FLASH_BWD_CASES = ((1000, 1000, True, 0), (1000, 1000, False, 0),
                   (100, 300, False, 0), (100, 300, True, 37),
                   (100, 300, True, 200), (300, 100, True, -64),
                   (127, 127, True, 0), (129, 257, True, 128))
FLASH_TOL = {"float32": dict(rtol=1e-5, atol=2e-5),
             "bfloat16": dict(rtol=2e-2, row_rms=2e-2)}
FLASH_LSE_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
                 "bfloat16": dict(rtol=1e-5, atol=1e-3)}


def flash_out_close(torch, out, ref, dtype_name):
    """Assert out within FLASH_TOL of ref; returns (largest abs error, the
    largest error over its element's allowance: <= 1 passes)."""
    tol = FLASH_TOL[dtype_name]
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    if "atol" in tol:
        allow = tol["atol"] + tol["rtol"] * r.abs()
    else:
        rms = r.pow(2).mean(-1, keepdim=True).sqrt()
        allow = tol["rtol"] * r.abs() + tol["row_rms"] * rms
    ratio = float(torch.where(err > 0, err / allow, torch.zeros_like(err))
                  .max()) if err.numel() else 0.0
    assert ratio <= 1.0, (f"flash_attention {dtype_name}: error "
                          f"{float(err.max()):.3e} exceeds {tol} by "
                          f"{ratio:.3f}x")
    return float(err.max()) if err.numel() else 0.0, ratio


# the backward kernels against the plain backward, per element of dq, dk,
# dv: |err| <= rtol |ref| + row_rms * rms(ref row over head_dim) +
# tensor_rms * rms(ref).  bf16: the kernels round p and ds to bf16 where
# they enter mma (the plain version keeps them float32), and both round the
# gradients to bf16 once; a CPU emulation of that rounding
# (tools/torch_flash_bwd_rounding.py) needs row_rms 0.0088 at LT1's cases
# and a head each of the slice's and the bench shapes.  The tensor_rms
# floor covers rows whose exact gradient is 0 (a row that sees one key:
# ds = p (dp - delta) cancels), where both sides hold only float32
# rounding noise, ~1e-7 of the tensor's scale.
FLASH_BWD_TOL = {"float32": dict(rtol=1e-4, row_rms=1e-4, tensor_rms=1e-4),
                 "bfloat16": dict(rtol=2e-2, row_rms=2e-2, tensor_rms=1e-3)}


def grad_close(torch, got, ref, dtype_name, tol=None):
    """Assert a gradient within FLASH_BWD_TOL (or ``tol``) of the plain
    one; returns (largest abs error, its largest share of the allowance:
    <= 1 passes)."""
    tol = tol or FLASH_BWD_TOL[dtype_name]
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    if not err.numel():
        return 0.0, 0.0
    allow = (tol["rtol"] * r.abs()
             + tol["row_rms"] * r.pow(2).mean(-1, keepdim=True).sqrt()
             + tol["tensor_rms"] * r.pow(2).mean().sqrt())
    ratio = float(torch.where(err > 0, err / allow, torch.zeros_like(err))
                  .max())
    assert ratio <= 1.0 and bool(torch.isfinite(g).all()), (
        f"flash backward {dtype_name}: error {float(err.max()):.3e} exceeds "
        f"{tol} by {ratio:.3f}x")
    return float(err.max()), ratio


def flash_inputs(torch, B, H, S, K, hd, dtype, gen):
    return tuple(torch.randn(B, H, n, hd, generator=gen).to(DEVICE, dtype)
                 for n in (S, K, K))


def flash_check(torch, fa, q, k, v, causal, off, dtype_name):
    """One kernel call against the plain version: out and lse within the
    stated tolerances, rows with no valid key exactly 0 / -inf.  Returns
    out's largest abs error, its largest share of the tolerance and the
    count of rows with no valid key."""
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal,
                                          q_position_offset=off)
    ref, ref_lse = fa.flash_attention_fwd_lse_ref(q, k, v, causal,
                                                  q_position_offset=off)
    torch.cuda.synchronize()
    err, ratio = flash_out_close(torch, out, ref, dtype_name)
    dead = torch.isneginf(ref_lse)
    assert torch.equal(torch.isneginf(lse), dead)
    assert bool(torch.all(out[dead] == 0))
    torch.testing.assert_close(lse[~dead], ref_lse[~dead],
                               **FLASH_LSE_TOL[dtype_name])
    return err, ratio, int(dead.sum())


def check_flash_kernel(torch):
    """Phase L1: the flash-attention kernel against its plain version at
    head_dim 64, 128 and 256, float32 and bf16, causal and not, ragged S
    and K, K > S, offsets; then at the slice's own shape.  Returns the
    largest abs error at the slice's shape (bf16, causal)."""
    import importlib

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    gen = torch.Generator().manual_seed(SEED + 20)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for hd in fa.HEAD_DIMS:
            for S, K, causal, off in FLASH_CASES:
                q, k, v = flash_inputs(torch, 2, 3, S, K, hd, dtype, gen)
                err, ratio, dead = flash_check(torch, fa, q, k, v, causal,
                                               off, name)
                log(f"kernel flash_attention {name} hd={hd} S={S} K={K} "
                    f"causal={causal} offset={off}: max_abs_err={err:.3e} "
                    f"vs plain ({FLASH_TOL[name]}; {ratio:.3f} of it at "
                    f"most), {dead} rows with no valid key exactly 0 / "
                    f"-inf; ok")
    q, k, v = flash_inputs(torch, LC_B, 12, LC_S, LC_S, 64, torch.bfloat16,
                           gen)
    err, ratio, _ = flash_check(torch, fa, q, k, v, True, 0, "bfloat16")
    ref = fa.flash_attention_ref(q, k, v, True).float()
    log(f"kernel flash_attention bfloat16 at the slice's shape "
        f"[{LC_B}, 12, {LC_S}, 64] causal: max_abs_err={err:.3e}, "
        f"{ratio:.3f} of the tolerance ({FLASH_TOL['bfloat16']}; median "
        f"|out| {float(ref.abs().median()):.3e}, median row RMS "
        f"{float(ref.pow(2).mean(-1).sqrt().median()):.3e}); ok")
    return err


def long_context_model(torch, dtype, layers=12, S=LC_S, device=DEVICE):
    """GPTForCausalLM(gpt_small(max_position=S, dropout=0.0)) with seeded
    random weights (drawn on the CPU, so any device gets the same
    model)."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_small

    net = GPTForCausalLM(
        gpt_small(max_position=S, dropout=0.0, num_layers=layers),
        device=device, generator=torch.Generator().manual_seed(SEED))
    return net.astype(dtype) if dtype != "float32" else net


def long_context_inference(torch, gpu):
    """Phase L2: the slice model in bf16 at 2 x 8192 through
    ``eval_batch`` (loss, perplexity) and ``predict_batch`` (logits), the
    counts zeroed just before and read just after; then the same model
    with the flash gate closed (the dense einsum) for peak memory."""
    import math

    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.gpt import ParallelAttention
    from paddle_tpu_torch.ops import (flash_attention, layernorm_residual,
                                      softmax_cross_entropy)

    net = long_context_model(torch, "bfloat16")
    layers = net.gpt.cfg.num_layers
    model = ptt.Model(net).prepare(loss=net.loss)
    ids = np.random.RandomState(SEED + 21).randint(
        0, net.gpt.cfg.vocab_size, size=(LC_B, LC_S)).astype(np.int32)
    model.eval_batch([ids], [ids])  # warm-up: cuBLAS plans, allocator
    torch.cuda.synchronize()
    counters = (flash_attention, layernorm_residual, softmax_cross_entropy)
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
        if hasattr(c, "backward_launches"):  # layernorm_residual's
            c.backward_launches = 0
    t0 = time.monotonic()
    losses = [model.eval_batch([ids], [ids])[0] for _ in range(LC_EVALS)]
    torch.cuda.synchronize()
    t_eval = (time.monotonic() - t0) / LC_EVALS
    t0 = time.monotonic()
    for _ in range(LC_PREDICTS):
        logits = model.predict_batch([ids])
    torch.cuda.synchronize()
    t_pred = (time.monotonic() - t0) / LC_PREDICTS
    fa, ln, sx = (c.launches for c in counters)
    peak = torch.cuda.max_memory_allocated()
    forwards = LC_EVALS + LC_PREDICTS
    log(f"long[{gpu}]: gpt_small(max_position={LC_S}, dropout=0.0) bf16, "
        f"{layers} layers, batch {LC_B}x{LC_S}: eval_batch losses "
        f"{losses} (perplexity {math.exp(losses[-1]):.1f}); launches over "
        f"{LC_EVALS} eval_batch + {LC_PREDICTS} predict_batch: "
        f"flash_attention {fa} (= {layers} x {forwards}: "
        f"{fa == layers * forwards}), layernorm_residual {ln}, "
        f"softmax_cross_entropy {sx}")
    assert fa == layers * forwards, fa
    assert ln == layers * forwards, ln
    assert sx == LC_EVALS, sx
    assert all(math.isfinite(x) for x in losses), losses
    assert tuple(logits.shape) == (LC_B, LC_S, net.gpt.cfg.vocab_size)
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits).all())
    del logits
    tok = LC_B * LC_S
    log(f"long[{gpu}]: flash: eval_batch {t_eval * 1e3:.1f} ms "
        f"({tok / t_eval:.0f} tokens/s), predict_batch {t_pred * 1e3:.1f} "
        f"ms ({tok / t_pred:.0f} tokens/s), peak device memory "
        f"{peak / 2**20:.0f} MiB")

    flash_use = ParallelAttention._use_flash
    ParallelAttention._use_flash = lambda self, S, attn_mask, x: False
    try:
        model.eval_batch([ids], [ids])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.monotonic()
        dense_loss = model.eval_batch([ids], [ids])[0]
        torch.cuda.synchronize()
        t_dense = time.monotonic() - t0
        dense_peak = torch.cuda.max_memory_allocated()
        assert flash_attention.launches == 0
    finally:
        ParallelAttention._use_flash = flash_use
    rel = abs(dense_loss - losses[-1]) / abs(dense_loss)
    log(f"long[{gpu}]: dense (gate closed): eval_batch {t_dense * 1e3:.1f} "
        f"ms ({tok / t_dense:.0f} tokens/s), loss {dense_loss} (flash "
        f"{losses[-1]}, rel diff {rel:.2e} <= 1e-2: the dense path keeps "
        f"bf16 scores), peak device memory {dense_peak / 2**20:.0f} MiB "
        f"vs flash {peak / 2**20:.0f} MiB")
    assert peak < dense_peak, (peak, dense_peak)
    assert rel <= 1e-2, rel
    del model, net
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": fa, "loss": losses[-1], "eval_ms": t_eval * 1e3,
            "predict_ms": t_pred * 1e3, "dense_ms": t_dense * 1e3,
            "peak_bytes": peak, "dense_peak_bytes": dense_peak}


def long_context_card_vs_cpu(torch):
    """Phase L3: a 2-layer gpt_small-width model in float32 at S 4096,
    one seeded init on both devices: the card through the flash kernel,
    the CPU through the dense path (its gate is closed off the card).
    eval_batch losses at rtol 1e-4; predict_batch logits within rtol 1e-4
    / atol 1e-4 (float32 sums in other orders, 2 layers)."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import flash_attention

    B, S, layers = LC_PARITY["B"], LC_PARITY["S"], LC_PARITY["layers"]
    ids = np.random.RandomState(SEED + 22).randint(
        0, 50304, size=(B, S)).astype(np.int32)
    got = {}
    for dev in (DEVICE, "cpu"):
        net = long_context_model(torch, "float32", layers, S, dev)
        model = ptt.Model(net).prepare(loss=net.loss)
        flash_attention.launches = 0
        loss = model.eval_batch([ids], [ids])[0]
        logits = model.predict_batch([ids]).cpu()
        got[dev] = (loss, logits, flash_attention.launches)
        del model, net
    (lc, xc, nc), (lh, xh, nh) = got[DEVICE], got["cpu"]
    err = float((xc - xh).abs().max())
    log(f"long parity: gpt_small width, {layers} layers, f32, {B}x{S}: "
        f"eval_batch loss card {lc} (flash, {nc} launches) vs cpu {lh} "
        f"(dense), rel diff {abs(lc - lh) / abs(lh):.2e} (<= 1e-4); logits "
        f"max abs diff {err:.3e} (rtol 1e-4, atol 1e-4)")
    assert nc == 2 * layers and nh == 0, (nc, nh)
    assert abs(lc - lh) <= 1e-4 * abs(lh), (lc, lh)
    torch.testing.assert_close(xc, xh, rtol=1e-4, atol=1e-4)
    gc.collect()
    torch.cuda.empty_cache()
    return err


def timing_flash(torch, gpu):
    """Phase L4: the kernel, its plain version and
    ``torch.nn.functional.scaled_dot_product_attention(is_causal=True)``
    (the library yardstick; the port never calls it) at the slice's shape
    and at bench.py's op shape, bf16, causal, median (min-max) of 3 runs
    from CUDA events, beside the bound: the operations of the causal
    pairs, 4 * B*H * S(S+1)/2 * hd, at 989 TFLOP/s, or the bytes (q, k,
    v read, out and lse written) at 3.35 TB/s where larger."""
    import importlib

    import torch.nn.functional as F

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    gen = torch.Generator().manual_seed(SEED + 23)
    rows = {}
    with torch.no_grad():
        for name, (Bq, Hq, S, hd) in (("slice", (LC_B, 12, LC_S, 64)),
                                      ("bench_op", BENCH_OP)):
            args = [flash_inputs(torch, Bq, Hq, S, S, hd, torch.bfloat16,
                                 gen)]
            flops = 4.0 * Bq * Hq * (S * (S + 1) // 2) * hd
            iters = max(3, int(2e13 // flops))
            ms = runs_ms(torch, lambda q, k, v: fa.flash_attention_fwd_lse(
                q, k, v, True), args, iters)
            plain = runs_ms(torch, lambda q, k, v:
                            fa.flash_attention_fwd_lse_ref(q, k, v, True),
                            args, max(2, iters // 10))
            lib = runs_ms(torch, lambda q, k, v:
                          F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True),
                          args, iters)
            nbytes = 4 * Bq * Hq * S * hd * 2 + Bq * Hq * S * 4
            t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
            rows[name] = dict(ms=ms[0], plain_ms=plain[0], library_ms=lib[0],
                              bound_ms=max(t_b, t_o) * 1e3,
                              bound_by="bytes" if t_b >= t_o
                              else "operations")
            log(f"timing[{gpu}] flash_attention bf16 causal {name} "
                f"[{Bq}, {Hq}, {S}, {hd}]: kernel {ms[0]:.4f} "
                f"({ms[1]:.4f}-{ms[2]:.4f}) ms = "
                f"{flops / ms[0] / 1e9:.1f} TFLOP/s, plain {plain[0]:.4f} "
                f"({plain[1]:.4f}-{plain[2]:.4f}) ms, library "
                f"(F.scaled_dot_product_attention) {lib[0]:.4f} "
                f"({lib[1]:.4f}-{lib[2]:.4f}) ms, bound "
                f"{max(t_b, t_o) * 1e3:.4f} ms by "
                f"{rows[name]['bound_by']} ({flops:.4g} flops, {nbytes} "
                f"bytes)")
            del args
            gc.collect()
            torch.cuda.empty_cache()
    return rows


WIDE_LN = (2 * 1024, 1024)     # the hidden-1024 GPT's rows x width below
# (q dtype, pool) pairs of the paged kernel's chunked instance
PAGED_WIDE_DTYPES = (("float32", None), ("float32", "int8"),
                     ("float32", "fp8"), ("bfloat16", None),
                     ("bfloat16", "int8"), ("bfloat16", "fp8"))


def check_width_repairs(torch, gpu):
    """Phase W: the port at widths it used to refuse on the card.
    ``layernorm_residual``'s wide variant against its plain version (and
    timed) at the hidden-1024 GPT's shape, float32 and bf16; that GPT
    (gpt_small(hidden_size=1024, num_heads=16), float32, 12 layers) takes
    one train_batch, its 12 layernorm_residual launches through the wide
    variant; paged_flash_decode at head_dim 320 and at page 1024 (staged in
    row chunks), each over every q dtype and pool kind, against its plain
    version.  Returns the wide variant's errors and times by dtype."""
    import math

    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_small
    from paddle_tpu_torch.ops import fused_layernorm as fl
    from paddle_tpu_torch.ops import layernorm_residual
    from paddle_tpu_torch.ops.paged_attention import (
        paged_flash_decode, paged_flash_decode_ref)

    M, D = WIDE_LN
    assert fl.MAX_FEATURES < D <= fl.MAX_REGISTER_FEATURES
    gen = torch.Generator().manual_seed(SEED + 26)
    wide = {}
    for dtype in ("float32", "bfloat16"):
        err, bwd_err = check_ln(torch, fl, dtype, M, D, gen)
        with torch.no_grad():
            wide[dtype] = time_ln(torch, fl, gpu, dtype, M, D, True, gen)
        wide[dtype]["max_abs_err"] = err
        wide[dtype]["backward"]["max_abs_err"] = bwd_err
    net = GPTForCausalLM(gpt_small(hidden_size=1024, num_heads=16),
                         device=DEVICE,
                         generator=torch.Generator().manual_seed(SEED))
    model = ptt.Model(net).prepare(
        optimizer=ptt.optimizer.AdamW(learning_rate=1e-4,
                                      multi_precision=True), loss=net.loss)
    ids = np.random.RandomState(SEED + 24).randint(
        0, 50304, size=(2, 1024)).astype(np.int32)
    assert ids.size == M
    layernorm_residual.launches = layernorm_residual.backward_launches = 0
    loss = model.train_batch([ids], [ids])[0]
    torch.cuda.synchronize()
    ln, lnb = layernorm_residual.launches, layernorm_residual.backward_launches
    log(f"wide[{gpu}]: gpt_small(hidden_size=1024, num_heads=16) f32, "
        f"batch 2x1024: train_batch loss {loss}, layernorm_residual "
        f"launches {ln} (= 12), backward {lnb} (= 12)")
    assert math.isfinite(loss) and ln == lnb == 12, (loss, ln, lnb)
    wide["launches_train_batch_hidden_1024"] = ln
    wide["backward_launches_train_batch_hidden_1024"] = lnb
    del model, net
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(SEED + 25)
    for hd, page, G in ((320, 16, 16), (64, 1024, 2)):
        Bp, Hp, T = 4, 4, 5
        P = Bp * G
        tables = torch.randperm(P, generator=gen).reshape(Bp, G)
        lengths = torch.tensor([G * page - 1 - 50 * b for b in range(Bp)])
        kp = torch.arange(G * page)
        mask = (kp[None, None, :] <= (lengths[:, None, None] - T
                                      + torch.arange(T)[None, :, None]))
        mask[1, 0] = False
        q = torch.randn(Bp, Hp, T, hd, generator=gen).to(DEVICE)
        pools = [torch.randn(P + 1, Hp, page, hd, generator=gen).to(DEVICE)
                 for _ in range(2)]
        for qdt, pool in PAGED_WIDE_DTYPES:
            dt = getattr(torch, qdt)
            if pool is None:
                kv = (pools[0].to(dt), pools[1].to(dt), None, None)
            else:
                kv = quantize_pools(torch, *pools, dict(
                    int8=torch.int8, fp8=torch.float8_e4m3fn)[pool])
            args = (q.to(dt), kv[0], kv[1], tables.int().to(DEVICE),
                    mask.to(DEVICE), kv[2], kv[3])
            before = paged_flash_decode.launches
            out = paged_flash_decode(*args)
            ref = paged_flash_decode_ref(*args)
            torch.cuda.synchronize()
            assert paged_flash_decode.launches == before + 1
            # bf16: the same float32 arithmetic, both outputs rounded to
            # bf16 once (one ulp apart at most)
            tol = (dict(rtol=1e-4, atol=2e-5) if qdt == "float32"
                   else dict(rtol=1e-2, atol=1e-5))
            torch.testing.assert_close(out, ref, **tol)
            assert bool(torch.all(out.permute(0, 2, 1, 3)[1, 0] == 0)), \
                "a fully-masked row must be exactly 0"
            err = float((out.float() - ref.float()).abs().max())
            log(f"wide: paged_flash_decode {qdt} q, {pool or qdt} pool, "
                f"hd={hd} page={page} G={G} T={T}: max_abs_err={err:.3e} "
                f"vs plain (rtol {tol['rtol']}, atol {tol['atol']}) ok")
    return wide


# -- long-context GPT training (flash attention backward) ---------------------
LT_WARMUP, LT_STEPS = 2, 5
LT_PARITY = dict(B=1, S=4096, layers=2)
# LT3: every parameter's step-1 gradient, card (kernels 4-6) against the
# CPU (dense), within this share of its L2 norm; float32 on both sides,
# summed in other orders (the port's plain flash route and its dense route
# differ by ~1e-6 in L2 on the CPU at hidden 256)
LT_GRAD_RTOL = 1e-4
LT_LOSS_RTOL = 1e-4


def bwd_inputs(torch, fa, B, H, S, K, hd, dtype, gen, causal=True, off=0):
    """q, k, v, dO from a seed, and the forward kernel's out and lse."""
    q, k, v, do = (torch.randn(B, H, n, hd, generator=gen).to(DEVICE, dtype)
                   for n in (S, K, K, S))
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal,
                                          q_position_offset=off)
    return q, k, v, do, out, lse


def flash_bwd_check(torch, fa, args, causal, off, dtype_name):
    """One backward (both kernels, through flash_attention_bwd_chunk)
    against the plain backward: dq, dk, dv within FLASH_BWD_TOL, dq of rows
    with no valid key exactly 0.  Returns ({"dq": err, "dk": ..., "dv":
    ...}, largest share of the tolerance, rows with no valid key, the
    kernels' gradients)."""
    q, k, v, do, out, lse = args
    got = fa.flash_attention_bwd_chunk(q, k, v, out, lse, do, causal,
                                       q_position_offset=off)
    ref = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                     q_position_offset=off)
    torch.cuda.synchronize()
    errs, worst = {}, 0.0
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        errs[name], ratio = grad_close(torch, g, r, dtype_name)
        worst = max(worst, ratio)
    dead = torch.isneginf(lse)
    assert bool(torch.all(got[0][dead] == 0)), "keyless rows: dq must be 0"
    return errs, worst, int(dead.sum()), got


def check_flash_bwd_kernels(torch):
    """Phase LT1: the dq and dk / dv kernels against the plain backward at
    head_dim 64, 128 and 256, float32 and bf16, LT1's cases (S = K, S != K
    ragged, causal and not, offsets 0, 37, K - S, -64 with keyless rows,
    S = 127 and 129 against the bf16 blocks of 128); then bf16 causal at
    the slice's shape (twice: bit-equal) and at bench.py's op shape; then
    flash_attention_bwd_chunk over two kv chunks of a ring step, whose
    partials must sum to the full gradient.  Returns
    the largest abs errors at the slice's shape: {"dq": ..., "dkv": ...}."""
    import importlib

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    gen = torch.Generator().manual_seed(SEED + 30)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for hd in fa.HEAD_DIMS:
            for S, K, causal, off in FLASH_BWD_CASES:
                args = bwd_inputs(torch, fa, 2, 3, S, K, hd, dtype, gen,
                                  causal, off)
                errs, worst, dead, _ = flash_bwd_check(torch, fa, args,
                                                       causal, off, name)
                log(f"kernel flash_attention_bwd {name} hd={hd} S={S} K={K} "
                    f"causal={causal} offset={off}: max_abs_err dq "
                    f"{errs['dq']:.3e} dk {errs['dk']:.3e} dv "
                    f"{errs['dv']:.3e} vs plain ({FLASH_BWD_TOL[name]}; "
                    f"{worst:.3f} of it at most), {dead} keyless rows with "
                    f"dq exactly 0; ok")
    out = {}
    for label, (B, H, S, hd) in (("slice", (LC_B, 12, LC_S, 64)),
                                 ("bench_op", BENCH_OP)):
        args = bwd_inputs(torch, fa, B, H, S, S, hd, torch.bfloat16, gen)
        errs, worst, _, got = flash_bwd_check(torch, fa, args, True, 0,
                                              "bfloat16")
        q, k, v, do, o, lse = args
        again = fa.flash_attention_bwd_chunk(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        assert same, "two runs of the backward kernels differ"
        log(f"kernel flash_attention_bwd bfloat16 causal at the {label} "
            f"shape [{B}, {H}, {S}, {hd}]: max_abs_err dq {errs['dq']:.3e} "
            f"dk {errs['dk']:.3e} dv {errs['dv']:.3e}, {worst:.3f} of the "
            f"tolerance ({FLASH_BWD_TOL['bfloat16']}); two runs bit-equal")
        if label == "slice":
            out = {"dq": errs["dq"], "dkv": max(errs["dk"], errs["dv"])}
        del args, got, again, q, k, v, do, o, lse
        gc.collect()
        torch.cuda.empty_cache()
    # a ring step: q rows at global positions 1024.., keys 0..2047 in two
    # chunks, the merged out / lse of the full forward
    q, k, v, do, o, lse = bwd_inputs(torch, fa, 2, 4, 1024, 2048, 64,
                                     torch.float32, gen, True, 1024)
    full = fa.flash_attention_bwd_chunk(q, k, v, o, lse, do, True,
                                        q_position_offset=1024)
    delta = (do * o).sum(-1)
    parts = [fa.flash_attention_bwd_chunk(
        q, k[:, :, a:b], v[:, :, a:b], None, lse, do, True,
        q_position_offset=1024 - a, delta=delta)
        for a, b in ((0, 1024), (1024, 2048))]
    torch.cuda.synchronize()
    e_q = grad_close(torch, parts[0][0] + parts[1][0], full[0], "float32")
    e_k = [grad_close(torch, torch.cat([p[i] for p in parts], 2), full[i],
                      "float32") for i in (1, 2)]
    log(f"kernel flash_attention_bwd_chunk float32, two kv chunks of a ring "
        f"step (q at 1024.., keys 0..2047): partials sum to the full "
        f"gradient, max_abs_err dq {e_q[0]:.3e} dk {e_k[0][0]:.3e} dv "
        f"{e_k[1][0]:.3e}; ok")
    return out


def long_context_training(torch, gpu, ln_backward_kernel=True):
    """Phase LT2: the slice model in bf16 with AdamW(multi_precision)
    through Model.train_batch at 2 x 8192, the same seeded batch every
    step, LT_WARMUP + LT_STEPS steps, the counts zeroed just before the
    timed steps; then the same model at 1 x 8192 through the flash route
    and with the gate closed (the dense einsum), for step time and peak
    memory.  ``ln_backward_kernel`` as for :func:`train_bert`."""
    import math

    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.gpt import ParallelAttention
    from paddle_tpu_torch.ops import (flash_attention, layernorm_residual,
                                      softmax_cross_entropy)
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq)

    net = long_context_model(torch, "bfloat16")
    layers = net.gpt.cfg.num_layers
    opt = ptt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                              multi_precision=True)
    model = ptt.Model(net).prepare(optimizer=opt, loss=net.loss)
    ids = np.random.RandomState(SEED + 31).randint(
        0, net.gpt.cfg.vocab_size, size=(LC_B, LC_S)).astype(np.int32)
    counters = (flash_attention, flash_attention_bwd_dq,
                flash_attention_bwd_dkv, layernorm_residual,
                softmax_cross_entropy)
    torch.cuda.reset_peak_memory_stats()
    losses, wall, (fa, dq, dkv, ln, sx) = train_steps(
        torch, model, [ids], [ids], LT_WARMUP, LT_STEPS, counters)
    peak = torch.cuda.max_memory_allocated()
    log(f"train_long: gpt_small(max_position={LC_S}, dropout=0.0) bf16, "
        f"{layers} layers, batch {LC_B}x{LC_S}, AdamW(1e-4, wd 0.01, "
        f"multi_precision): losses {[round(x, 4) for x in losses]}; "
        f"launches over {LT_STEPS} steps: flash_attention {fa}, "
        f"flash_attention_bwd_dq {dq}, flash_attention_bwd_dkv {dkv} (each "
        f"= {layers} x {LT_STEPS}: "
        f"{fa == dq == dkv == layers * LT_STEPS}), layernorm_residual {ln}, "
        f"softmax_cross_entropy {sx}")
    for c in (fa, dq, dkv, ln):
        assert c == layers * LT_STEPS, (fa, dq, dkv, ln)
    ln_backward_gate(layernorm_residual, ln, "train_long",
                     ln_backward_kernel)
    assert sx == LT_STEPS, sx
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    sd = opt.state_dict()
    masters = [v for k, v in sd.items() if k.endswith(".master")]
    assert len(masters) == len(list(net.parameters())) and all(
        m.dtype == torch.float32 for m in masters)
    tok = LC_B * LC_S
    step_ms = wall / LT_STEPS * 1e3
    log(f"train_long[{gpu}]: {LT_STEPS} steps in {wall:.3f}s = "
        f"{step_ms:.1f} ms/step, {tok * LT_STEPS / wall:.0f} tokens/s, peak "
        f"device memory {peak / 2**20:.0f} MiB, {len(masters)} float32 "
        f"master slots")

    one = ids[:1]
    routes = {}
    flash_use = ParallelAttention._use_flash
    for route in ("flash", "dense"):
        if route == "dense":
            ParallelAttention._use_flash = lambda self, S, attn_mask, x: False
        try:
            model.train_batch([one], [one])  # warm-up at this shape
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            flash_attention.launches = 0
            t0 = time.monotonic()
            rl = [model.train_batch([one], [one])[0] for _ in range(2)]
            torch.cuda.synchronize()
            routes[route] = dict(step_ms=(time.monotonic() - t0) / 2 * 1e3,
                                 peak=torch.cuda.max_memory_allocated(),
                                 loss=rl[-1],
                                 launches=flash_attention.launches)
        finally:
            ParallelAttention._use_flash = flash_use
    f, d = routes["flash"], routes["dense"]
    log(f"train_long[{gpu}]: 1x{LC_S}: flash {f['step_ms']:.1f} ms/step, "
        f"peak {f['peak'] / 2**20:.0f} MiB ({f['launches']} forward "
        f"launches in 2 steps); dense (gate closed) {d['step_ms']:.1f} "
        f"ms/step, peak {d['peak'] / 2**20:.0f} MiB ({d['launches']}); "
        f"losses {f['loss']} / {d['loss']}")
    assert f["launches"] == 2 * layers and d["launches"] == 0
    assert f["peak"] < d["peak"], (f["peak"], d["peak"])
    assert math.isfinite(d["loss"])
    del model, opt, net
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {"flash_attention": fa,
                         "flash_attention_bwd_dq": dq,
                         "flash_attention_bwd_dkv": dkv},
            "step_ms": step_ms, "tokens_per_s": tok * LT_STEPS / wall,
            "peak_bytes": peak, "first_loss": losses[0],
            "last_loss": losses[-1], "one_seq": routes}


def long_context_train_card_vs_cpu(torch):
    """Phase LT3: a 2-layer gpt_small-width model in float32 at 1 x 4096,
    one seeded init on both devices, two train_batch steps each: the card
    through kernels 4-6 (2 launches each a step), the CPU through the
    dense path (its gate is closed off the card).  The step-1 loss at rtol
    LT_LOSS_RTOL; every parameter's step-1 gradient, taken just before the
    optimizer steps, within LT_GRAD_RTOL of its L2 norm; the step-2 loss at
    LT_LOSS_RTOL."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import flash_attention
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq)

    B, S, layers = LT_PARITY["B"], LT_PARITY["S"], LT_PARITY["layers"]
    ids = np.random.RandomState(SEED + 32).randint(
        0, 50304, size=(B, S)).astype(np.int32)
    counters = (flash_attention, flash_attention_bwd_dq,
                flash_attention_bwd_dkv)
    got = {}
    for dev in (DEVICE, "cpu"):
        net = long_context_model(torch, "float32", layers, S, dev)
        opt = ptt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                  multi_precision=True)
        model = ptt.Model(net).prepare(optimizer=opt, loss=net.loss)
        grads = {}
        step = opt.step

        def step_after_recording(net=net, grads=grads, step=step):
            if not grads:  # step 1: the gradients before the update
                grads.update({n: p.grad.detach().cpu().clone()
                              for n, p in net.named_parameters()})
            step()

        opt.step = step_after_recording
        for c in counters:
            c.launches = 0
        losses = [model.train_batch([ids], [ids])[0] for _ in range(2)]
        got[dev] = (losses, grads, [c.launches for c in counters])
        del model, opt, net
    (lc, gc_, nc), (lh, gh, nh) = got[DEVICE], got["cpu"]
    worst = max((float((gc_[n] - gh[n]).norm() / gh[n].norm()), n)
                for n in gh)
    log(f"train_long parity: gpt_small width, {layers} layers, f32, {B}x{S}, "
        f"2 train_batch steps: losses card {lc} (launches flash / dq / dkv "
        f"{nc}) vs cpu {lh} (dense), rel diff "
        f"{[abs(a - b) / abs(b) for a, b in zip(lc, lh)]} (<= "
        f"{LT_LOSS_RTOL}); step-1 gradients: largest L2 share "
        f"{worst[0]:.2e} ({worst[1]}; <= {LT_GRAD_RTOL})")
    assert nc == [2 * layers] * 3 and nh == [0] * 3, (nc, nh)
    for a, b in zip(lc, lh):
        assert abs(a - b) <= LT_LOSS_RTOL * abs(b), (a, b)
    assert set(gc_) == set(gh) and worst[0] <= LT_GRAD_RTOL, worst
    gc.collect()
    torch.cuda.empty_cache()
    return worst[0]


def timing_flash_bwd(torch, gpu):
    """Phase LT4, bf16 causal at the slice's and bench.py's op shapes and
    at [1, 8, 8192, 256] (where kernel 6 keeps its first design): the
    dq and dk / dv kernels, the port's whole backward call (delta + both
    kernels), the plain backward and the library's backward
    (F.scaled_dot_product_attention(is_causal=True) through
    torch.autograd.grad with the graph kept: dq, dk, dv together), from
    CUDA events over inputs rotated past the L2, median (min-max) of 3 runs;
    beside each kernel's bound (operations: 6 and 8 flops a causal pair a
    head dim at 989 TFLOP/s, or its bytes at 3.35 TB/s where larger).  Then
    the port's forward + backward of bench.py's op against the library's."""
    import importlib

    import torch.nn.functional as F

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    gen = torch.Generator().manual_seed(SEED + 33)
    rows = {}
    for label, (B, H, S, hd) in (("slice", (LC_B, 12, LC_S, 64)),
                                 ("bench_op", BENCH_OP),
                                 ("hd256", (1, 8, 8192, 256))):
        scale = 1.0 / hd ** 0.5
        copies = []
        for _ in range(2):
            q, k, v, do, out, lse = bwd_inputs(torch, fa, B, H, S, S, hd,
                                               torch.bfloat16, gen)
            delta = (do.float() * out.float()).sum(-1)
            copies.append((q, k, v, do, out, lse, delta))
        pairs = B * H * (S * (S + 1) // 2)
        n_qkv = B * H * S * hd * 2  # one bf16 [B, H, S, hd] tensor
        stats = 2 * B * H * S * 4   # lse and delta
        iters = max(3, int(3e13 // (14.0 * pairs * hd)))
        with torch.no_grad():
            dq_ms = runs_ms(torch, lambda q, k, v, do, o, l, d:
                            fa.flash_attention_bwd_dq(q, k, v, do, l, d, True,
                                                      scale, 0),
                            copies, iters)
            dkv_ms = runs_ms(torch, lambda q, k, v, do, o, l, d:
                             fa.flash_attention_bwd_dkv(q, k, v, do, l, d,
                                                        True, scale, 0),
                             copies, iters)
            bwd_ms = runs_ms(torch, lambda q, k, v, do, o, l, d:
                             fa.flash_attention_bwd_chunk(q, k, v, o, l, do,
                                                          True),
                             copies, iters)
            plain = runs_ms(torch, lambda q, k, v, do, o, l, d:
                            fa.flash_attention_bwd_ref(q, k, v, o, l, do,
                                                       True, delta=d),
                            copies, max(2, iters // 20))
        graphs = []
        for q, k, v, do, *_ in copies:
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            graphs.append((F.scaled_dot_product_attention(
                qg, kg, vg, is_causal=True), (qg, kg, vg), do))
        lib = runs_ms(torch, lambda o, ins, do: torch.autograd.grad(
            o, ins, do, retain_graph=True), graphs, iters)
        del graphs
        row = {}
        for key, ms, flops, nbytes in (
                ("dq", dq_ms, 6.0 * pairs * hd, 5 * n_qkv + stats),
                ("dkv", dkv_ms, 8.0 * pairs * hd, 6 * n_qkv + stats)):
            t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
            row[key] = dict(ms=ms[0], plain_ms=plain[0], library_ms=lib[0],
                            bound_ms=max(t_b, t_o) * 1e3,
                            bound_by="bytes" if t_b >= t_o
                            else "operations")
            log(f"timing[{gpu}] flash_attention_bwd_{key} bf16 causal {label} "
                f"[{B}, {H}, {S}, {hd}]: kernel {ms[0]:.4f} ({ms[1]:.4f}-"
                f"{ms[2]:.4f}) ms = {flops / ms[0] / 1e9:.1f} TFLOP/s, bound "
                f"{row[key]['bound_ms']:.4f} ms by {row[key]['bound_by']} "
                f"({flops:.4g} flops, {nbytes} bytes)")
        row["bwd_ms"], row["plain_ms"], row["library_ms"] = (
            bwd_ms[0], plain[0], lib[0])
        log(f"timing[{gpu}] flash backward bf16 causal {label}: the port's "
            f"backward call (delta + dq + dk/dv) {bwd_ms[0]:.4f} "
            f"({bwd_ms[1]:.4f}-{bwd_ms[2]:.4f}) ms, plain "
            f"{plain[0]:.4f} ({plain[1]:.4f}-{plain[2]:.4f}) ms, library "
            f"(F.scaled_dot_product_attention backward: dq, dk, dv) "
            f"{lib[0]:.4f} ({lib[1]:.4f}-{lib[2]:.4f}) ms")
        if label == "bench_op":
            def port(q, k, v, do, *_):
                ins = tuple(t.detach().requires_grad_() for t in (q, k, v))
                return torch.autograd.grad(
                    fa.flash_attention(*ins, causal=True), ins, do)

            def library(q, k, v, do, *_):
                ins = tuple(t.detach().requires_grad_() for t in (q, k, v))
                return torch.autograd.grad(F.scaled_dot_product_attention(
                    *ins, is_causal=True), ins, do)

            fb = runs_ms(torch, port, copies, iters)
            lfb = runs_ms(torch, library, copies, iters)
            row["fwd_bwd_ms"], row["library_fwd_bwd_ms"] = fb[0], lfb[0]
            log(f"timing[{gpu}] flash_attention forward + backward bf16 "
                f"causal {label} [{B}, {H}, {S}, {hd}] (bench.py's op): port "
                f"{fb[0]:.4f} ({fb[1]:.4f}-{fb[2]:.4f}) ms, library "
                f"{lfb[0]:.4f} ({lfb[1]:.4f}-{lfb[2]:.4f}) ms")
        rows[label] = row
        del copies
        gc.collect()
        torch.cuda.empty_cache()
    return rows


# -- MoE GPT: training and paged serving (grouped matmul, kernel 10) ----------
# the slice: gpt_small width and depth, every block's MLP an 8-expert top-2
# MoELayer (GShard top-2 routing at capacity factor 1.25; Switch-Base-8's
# expert width), bf16, AdamW(multi_precision), 8 x 1024 tokens a step: N =
# 8192 routed rows a layer, C = ceil(2 x 8192 x 1.25 / 8) = 2560 slots
MOE_E, MOE_K = 8, 2
MOE_B, MOE_S = 8, 1024
MOE_WARMUP, MOE_STEPS = 2, 5
# serving: capacity factor = E, so C = k x N and no token is ever dropped
# (tools/moe_smoke.py's condition): routing in the padded batch is then
# per-token independent and the tokens must equal the uncached greedy
MOE_SERVE_CF = 8.0
# M3: a 2-layer float32 MoE, card (kernel 10) against CPU (masked einsum)
MOE_PARITY = dict(B=2, S=512, layers=2, hidden=256, heads=4, ffn=1024)
MOE_GRAD_RTOL = 1e-4
MOE_LOSS_RTOL = 1e-4
MOE_TIE = 1e-5                 # a routing margin below this is a near-tie
# kernel 10 against its plain version, per element: |y - ref| <= rel |ref| +
# floor rms(ref).  Both round one float32 sum once (bf16: one bf16 step)
GMM_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 1e-3)}


def moe_capacity():
    """Slots an expert at the slice: ceil(k N 1.25 / E) = 2560."""
    return math.ceil(MOE_K * MOE_B * MOE_S * 1.25 / MOE_E)


def moe_model(torch, dtype, device=DEVICE, **kw):
    """GPTForCausalLM(gpt_small(moe_experts=8, moe_top_k=2, dropout=0.0,
    **kw)) with seeded random weights drawn on the CPU."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_small

    cfg = dict(moe_experts=MOE_E, moe_top_k=MOE_K, dropout=0.0)
    cfg.update(kw)
    net = GPTForCausalLM(gpt_small(**cfg), device=device,
                         generator=torch.Generator().manual_seed(SEED))
    return net.astype(dtype) if dtype != "float32" else net


def routed_group_sizes(torch, N, dtype, cf, seed):
    """Group sizes of a real routing: a gpt_small-width MoELayer with
    seeded weights routes N seeded rows on the card.  Returns (routed rows
    an expert [E] int32 on the card, C)."""
    from paddle_tpu_torch.models import gpt_small
    from paddle_tpu_torch.moe import MoELayer, stats

    layer = MoELayer(gpt_small(moe_experts=MOE_E, moe_top_k=MOE_K,
                               moe_capacity_factor=cf))
    layer.reset_parameters(torch.Generator().manual_seed(seed))
    layer = layer.to(DEVICE, dtype).eval()
    x = torch.randn(N, layer.gate.shape[0],
                    generator=torch.Generator().manual_seed(seed + 1))
    with torch.no_grad(), stats.collect() as ms:
        layer(x.to(DEVICE, dtype))
    return ms.counts(MOE_E)[0], layer.capacity(N)


def gmm_inputs(torch, E, C, D, F, gs, dtype, gen):
    x = torch.randn(E, C, D, generator=gen).to(DEVICE, dtype)
    w = (torch.randn(E, D, F, generator=gen) / D ** 0.5).to(DEVICE, dtype)
    return x, w, torch.as_tensor(gs).to(DEVICE)


def gmm_check(torch, gmm, x, w, gs, dtype_name):
    """Kernel 10 on one case, its padding rows NaN: two launches bit-equal,
    padding rows exactly 0, every element within GMM_TOL of the plain
    version.  Returns (max abs error, the largest share of the tolerance
    used)."""
    C = x.shape[1]
    valid = (torch.arange(C, device=DEVICE)[None, :]
             < gs.clamp(0, C)[:, None])
    x = x.clone()
    x[~valid] = float("nan")
    y = gmm.grouped_matmul(x, w, gs)
    y2 = gmm.grouped_matmul(x, w, gs)
    ref = gmm.grouped_matmul_ref(x, w, gs)
    torch.cuda.synchronize()
    assert torch.equal(y, y2), "two launches differ"
    assert not bool(y[~valid].any()), "padding rows must be exactly 0"
    rel, floor = GMM_TOL[dtype_name]
    yf, rf = y.float(), ref.float()
    err = (yf - rf).abs()
    allowed = rel * rf.abs() + floor * float(rf.pow(2).mean().sqrt())
    assert bool((err <= allowed).all()), float(err.max())
    share = float((err / allowed.clamp_min(1e-30)).max())
    return float(err.max()), share


def check_grouped_matmul(torch):
    """Phase M1: kernel 10 against its plain version — the slice's fc1 /
    fc2 in bf16 with the group sizes of a real routing and with 0, C, > C,
    negative and sizes that are not tile multiples; float32 at the serving
    shapes: decode and verify (C = 16 and 80) and admission (C = 256 and
    768, with a real routing's group sizes and with the edge sizes); the
    JAX test's ragged shape and one with D not a multiple of 8.  Padding rows hold NaN.  Returns the largest error at
    the slice's shapes and the real group sizes."""
    import importlib

    from paddle_tpu_torch.framework.errors import InvalidArgumentError

    gmm = importlib.import_module("paddle_tpu_torch.ops.grouped_matmul")
    gs_train, C = routed_group_sizes(torch, MOE_B * MOE_S, torch.bfloat16,
                                     1.25, SEED + 40)
    assert C == moe_capacity(), C
    log(f"kernel grouped_matmul: a real routing of {MOE_B * MOE_S} rows at "
        f"capacity factor 1.25 fills the {MOE_E} experts' {C} slots with "
        f"{gs_train.tolist()} rows")
    edges = [0, C, C + 40, -3, 1, 127, 129, 2047]
    tile_edges = [0, 1, 127, 128, 129, C, C - 1, 256]
    # serving's admission calls: prompt buckets 16 and 48 at batch 8 route
    # N = 128 / 384 rows at capacity factor E, so C = 256 / 768 (> 128: the
    # 64 x 64 float32 tile, not the small-C one of decode)
    admit = []
    for n in (128, 384):
        gs_a, Ca = routed_group_sizes(torch, n, torch.float32, MOE_SERVE_CF,
                                      SEED + 44 + n)
        assert Ca == 2 * n, Ca
        admit += [("admission fc1 routed", MOE_E, Ca, 768, 3072, gs_a),
                  ("admission fc2 routed", MOE_E, Ca, 3072, 768, gs_a)]
    for Ca in (256, 768):
        edges_a = [0, Ca, Ca + 40, -3, 1, 63, 65, Ca - 1]
        admit += [("admission fc1 edges", MOE_E, Ca, 768, 3072, edges_a),
                  ("admission fc2 edges", MOE_E, Ca, 3072, 768, edges_a)]
    cases = [("fc1 routed", MOE_E, C, 768, 3072, gs_train, "bfloat16"),
             ("fc2 routed", MOE_E, C, 3072, 768, gs_train, "bfloat16"),
             ("fc1 edges", MOE_E, C, 768, 3072, edges, "bfloat16"),
             ("fc2 edges", MOE_E, C, 3072, 768, edges, "bfloat16"),
             # the 128-row tile's edges: empty, one row, one short of, at
             # and one past a tile, full, one short of full
             ("fc1 tile edges", MOE_E, C, 768, 3072, tile_edges,
              "bfloat16"),
             ("fc2 tile edges", MOE_E, C, 3072, 768, tile_edges,
              "bfloat16"),
             ("decode fc1", MOE_E, 16, 768, 3072, [16, 3, 0, 5, 1, 16, 2, 1],
              "float32"),
             ("verify fc2", MOE_E, 80, 3072, 768,
              [40, 20, 0, 80, 5, 7, 33, 80], "float32"),
             *[c + ("float32",) for c in admit],
             ("ragged", 3, 80, 16, 160, [80, 37, 0], "float32"),
             ("ragged", 3, 80, 16, 160, [80, 37, 0], "bfloat16"),
             ("D % 8 != 0", 3, 77, 13, 50, [77, 20, 1], "float32"),
             ("D % 8 != 0", 3, 77, 13, 50, [77, 20, 1], "bfloat16"),
             ("F % 8 != 0", 3, 80, 16, 50, [80, 37, 0], "bfloat16")]
    gen = torch.Generator().manual_seed(SEED + 43)
    slice_err = 0.0
    for name, E, Cc, D, F, gs, dt in cases:
        x, w, tgs = gmm_inputs(torch, E, Cc, D, F, gs, getattr(torch, dt),
                               gen)
        err, share = gmm_check(torch, gmm, x, w, tgs, dt)
        if "routed" in name or "edges" in name:
            slice_err = max(slice_err, err)
        design = ("wgmma" if gmm._use_wgmma(x.dtype, D, F, True)
                  else "first design")
        log(f"kernel grouped_matmul {dt} {name} [{E}, {Cc}, {D}] x [{E}, "
            f"{D}, {F}] ({design}) gs={tgs.tolist()}: max_abs_err={err:.3e}, "
            f"{share:.3f} of the tolerance (rel {GMM_TOL[dt][0]:.3g}, rms "
            f"{GMM_TOL[dt][1]:.3g}); padding rows (NaN in) exactly 0; two "
            f"launches bit-equal; ok")
        del x, w
    x, w, tgs = gmm_inputs(torch, 3, 80, 16, 160, [80, 37, 0], torch.float32,
                           gen)
    for bad in ((x, w[:, :8], tgs), (x[0], w, tgs), (x, w, tgs[:2]),
                (x, w, tgs.float())):
        try:
            gmm.grouped_matmul(*bad)
        except InvalidArgumentError:
            continue
        raise AssertionError("a wrong shape or dtype did not raise")
    log("kernel grouped_matmul: wrong shapes and a float group_sizes raise "
        "InvalidArgumentError; ok")
    return slice_err, gs_train


def train_moe(torch, gpu):
    """Phase M2, the slice's main path: the MoE GPT in bf16 with
    AdamW(1e-4, weight_decay=0.01, multi_precision=True) through
    Model.train_batch at 8 x 1024 tokens, one seeded batch, MOE_WARMUP +
    MOE_STEPS steps, the counts zeroed just before the timed steps and read
    just after; then one forward without gradient in train mode for the
    routing health and the aux loss after the last step."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.moe import stats
    from paddle_tpu_torch.ops import (grouped_matmul, layernorm_residual,
                                      softmax_cross_entropy)

    t0 = time.monotonic()
    net = moe_model(torch, "bfloat16")
    cfg = net.gpt.cfg
    layers = cfg.num_layers
    n_all = sum(p.numel() for p in net.parameters())
    n_exp = sum(p.numel() for n, p in net.named_parameters()
                if ".mlp.expert_" in n)
    log(f"train_moe: gpt_small(moe_experts={cfg.moe_experts}, moe_top_k="
        f"{cfg.moe_top_k}, dropout=0.0) bf16: hidden {cfg.hidden_size}, ffn "
        f"{cfg.intermediate_size}, {layers} layers, capacity factor "
        f"{cfg.moe_capacity_factor}, jitter {cfg.moe_jitter}, balance weight "
        f"{cfg.moe_balance_weight}; {n_all} parameters ({n_exp} in experts); "
        f"built in {time.monotonic() - t0:.1f}s")
    start = {n: p.detach().clone() for n, p in net.named_parameters()
             if n.endswith(("expert_fc1", "expert_fc2"))}
    opt = ptt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                              multi_precision=True)
    model = ptt.Model(net).prepare(optimizer=opt, loss=net.loss)
    ids = np.random.RandomState(SEED + 41).randint(
        0, cfg.vocab_size, size=(MOE_B, MOE_S)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    losses, wall, (gm, ln, sx) = train_steps(
        torch, model, [ids], [ids], MOE_WARMUP, MOE_STEPS,
        (grouped_matmul, layernorm_residual, softmax_cross_entropy))
    peak = torch.cuda.max_memory_allocated()
    log(f"train_moe: batch {MOE_B}x{MOE_S}, losses "
        f"{[round(x, 4) for x in losses]}; launches over {MOE_STEPS} steps: "
        f"grouped_matmul {gm} (= 2 x {layers} x {MOE_STEPS}: "
        f"{gm == 2 * layers * MOE_STEPS}), layernorm_residual {ln}, "
        f"softmax_cross_entropy {sx}")
    assert gm == 2 * layers * MOE_STEPS, gm
    assert ln == layers * MOE_STEPS and sx == MOE_STEPS, (ln, sx)
    ln_backward_gate(layernorm_residual, ln, "train_moe")
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    net.train()
    with torch.no_grad(), stats.collect() as ms:
        net.gpt(torch.from_numpy(ids).long().to(DEVICE))
    counts = ms.counts(MOE_E).cpu()
    aux = float(ms.total_aux()) / layers
    routed, dropped = int(counts[0].sum()), int(counts[1].sum())
    assert routed + dropped == layers * MOE_B * MOE_S * MOE_K
    assert math.isfinite(aux), aux
    sd = opt.state_dict()
    for n, p in net.named_parameters():
        master = sd[f"{n}.master"]
        assert master.dtype == torch.float32 and torch.equal(
            p.detach(), master.to(p.dtype)), n
    for n, p0 in start.items():
        moved = (sd[f"{n}.master"] - p0.float()).abs().amax(dim=(1, 2))
        assert bool((moved > 0).all()), (n, moved.tolist())
    tok = MOE_B * MOE_S
    step_ms = wall / MOE_STEPS * 1e3
    log(f"train_moe: after the last step, aux loss {aux:.4f} a layer (1 when "
        f"balanced), routed rows an expert over the layers "
        f"{counts[0].tolist()}, dropped {counts[1].tolist()}: overflow "
        f"fraction {dropped / (routed + dropped):.4f}; every expert's float32 "
        f"master moved ({len(start)} expert tensors x {MOE_E}); bf16 "
        f"parameters equal to their masters rounded")
    log(f"train_moe[{gpu}]: {MOE_STEPS} steps in {wall:.3f}s = "
        f"{step_ms:.1f} ms/step, {tok * MOE_STEPS / wall:.0f} tokens/s, peak "
        f"device memory {peak / 2**20:.0f} MiB")
    del model, opt, net, start
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {"grouped_matmul": gm}, "step_ms": step_ms,
            "tokens_per_s": tok * MOE_STEPS / wall, "peak_bytes": peak,
            "first_loss": losses[0], "last_loss": losses[-1], "aux": aux,
            "overflow": dropped / (routed + dropped)}


def routing_margins(probs, k):
    """Per row, the smallest gap between neighbouring probabilities among
    the k + 1 largest: how far the row is from a different top-k."""
    top = probs.sort(dim=-1, descending=True).values[:, :k + 1]
    return (top[:, :-1] - top[:, 1:]).min(dim=-1).values


def moe_card_vs_cpu(torch):
    """Phase M3: a 2-layer float32 MoE (hidden 256, FFN 1024, so the card
    runs kernel 10; 8 experts, top-2, capacity factor 1.25,
    jitter 0) at 2 x 512, one seeded init on both devices, two
    train_batch steps each: the card through the kernel, the CPU through
    the masked einsum.  Step-1 routing identical (a differing decision
    must be a near-tie, margin below MOE_TIE, and is printed); both losses
    at rtol MOE_LOSS_RTOL; every step-1 gradient, taken just before the
    optimizer steps, within MOE_GRAD_RTOL of its L2 norm."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.moe import MoELayer
    from paddle_tpu_torch.ops import grouped_matmul

    p = MOE_PARITY
    ids = np.random.RandomState(SEED + 42).randint(
        0, 50304, size=(p["B"], p["S"])).astype(np.int32)
    route = MoELayer._route
    got = {}
    for dev in (DEVICE, "cpu"):
        net = moe_model(torch, "float32", dev, hidden_size=p["hidden"],
                        num_heads=p["heads"], intermediate_size=p["ffn"],
                        num_layers=p["layers"], moe_jitter=0.0)
        opt = ptt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                  multi_precision=True)
        model = ptt.Model(net).prepare(optimizer=opt, loss=net.loss)
        grads, routes = {}, []
        step = opt.step

        def step_after_recording(net=net, grads=grads, step=step):
            if not grads:  # step 1: the gradients before the update
                grads.update({n: q.grad.detach().cpu().clone()
                              for n, q in net.named_parameters()})
            step()

        def recording_route(self, xf, C, routes=routes):
            out = route(self, xf, C)
            if len(routes) < p["layers"]:  # step 1's forward
                routes.append([t.detach().cpu() for t in out])
            return out

        opt.step = step_after_recording
        MoELayer._route = recording_route
        grouped_matmul.launches = 0
        try:
            losses = [model.train_batch([ids], [ids])[0] for _ in range(2)]
        finally:
            MoELayer._route = route
        got[dev] = (losses, grads, routes, grouped_matmul.launches)
        del model, opt, net
    (lc, gc_, rc, nc), (lh, gh, rh, nh) = got[DEVICE], got["cpu"]
    differ, margins = 0, []
    for layer, (a, b) in enumerate(zip(rc, rh)):
        probs, top_e, slot, kept = b[0], b[2], b[3], b[4]
        rows = (a[2] != top_e).any(-1)
        if bool(rows.any()):
            m = routing_margins(probs, top_e.shape[1])[rows]
            differ += int(rows.sum())
            margins += m.tolist()
            log(f"moe parity: layer {layer}: {int(rows.sum())} rows route "
                f"to other experts on the card; their margins {m.tolist()}")
        else:
            assert torch.equal(a[3], slot) and torch.equal(a[4], kept), layer
    assert all(m < MOE_TIE for m in margins), margins
    worst = max((float((gc_[n] - gh[n]).norm() / gh[n].norm()), n)
                for n in gh)
    smallest = min(float(routing_margins(b[0], b[2].shape[1]).min())
                   for b in rh)
    log(f"moe parity: 2-layer MoE f32 (hidden {p['hidden']}, ffn {p['ffn']}, "
        f"{MOE_E} experts, top-{MOE_K}), {p['B']}x{p['S']}, 2 train_batch "
        f"steps: step-1 routing {'identical' if not differ else 'differs'} "
        f"({differ} rows; smallest routing margin on the CPU "
        f"{smallest:.3e}); losses card {lc} (grouped_matmul launches {nc}) "
        f"vs cpu {lh} (einsum, {nh}), rel diff "
        f"{[abs(a - b) / abs(b) for a, b in zip(lc, lh)]} (<= "
        f"{MOE_LOSS_RTOL}); step-1 gradients: largest L2 share "
        f"{worst[0]:.2e} ({worst[1]}; <= {MOE_GRAD_RTOL})")
    assert nc == 2 * p["layers"] * 2 and nh == 0, (nc, nh)
    for a, b in zip(lc, lh):
        assert abs(a - b) <= MOE_LOSS_RTOL * abs(b), (a, b)
    assert set(gc_) == set(gh) and worst[0] <= MOE_GRAD_RTOL, worst
    gc.collect()
    torch.cuda.empty_cache()
    return worst[0]


def gmm_bound(gs, E, C, D, F, dtype):
    """Least time for one call: 2 sum(gs) D F operations at the dtype's
    peak, or the bytes — the valid x rows, w of the experts that have rows,
    the whole output, gs — at 3.35 TB/s, whichever is larger."""
    g = gs.clamp(0, C)
    item = 2 if dtype == "bfloat16" else 4
    rows, active = int(g.sum()), int((g > 0).sum())
    nbytes = rows * D * item + active * D * F * item + E * C * F * item + 4 * E
    flops = 2.0 * rows * D * F
    peak = BF16_FLOPS if dtype == "bfloat16" else FP32_FLOPS
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            nbytes, flops)


def timing_gmm(torch, gpu, gs_train):
    """Phase M5: kernel 10 at the slice's fc1 / fc2 (bf16, the group sizes
    of M1's real routing) and at the decode shapes (float32, a real
    routing of 8 and 40 rows at capacity factor 8: T = 1 and 5), from CUDA
    events over two input copies (past the 50 MB L2), median (min-max) of
    3 runs; beside the plain version, torch.bmm over the full buffers (the
    library's product alone, no masking) and the bound."""
    import importlib

    gmm = importlib.import_module("paddle_tpu_torch.ops.grouped_matmul")
    gen = torch.Generator().manual_seed(SEED + 44)
    cases = [("train_fc1", 768, 3072, gs_train, moe_capacity(), "bfloat16"),
             ("train_fc2", 3072, 768, gs_train, moe_capacity(), "bfloat16")]
    for T in (1, 5):
        gs, C = routed_group_sizes(torch, B * T, torch.float32, MOE_SERVE_CF,
                                   SEED + 45 + T)
        cases += [(f"decode_fc1_T{T}", 768, 3072, gs, C, "float32"),
                  (f"decode_fc2_T{T}", 3072, 768, gs, C, "float32")]
    rows = {}
    with torch.no_grad():
        for name, D, F, gs, C, dt in cases:
            args = [gmm_inputs(torch, MOE_E, C, D, F, gs, getattr(torch, dt),
                               gen) for _ in range(2)]
            b_ms, b_by, nbytes, flops = gmm_bound(gs, MOE_E, C, D, F, dt)
            iters = max(20, min(400, int(2.0 / max(b_ms, 1e-3))))
            ms = runs_ms(torch, gmm._forward_kernel, args, iters)
            plain = runs_ms(torch, gmm.grouped_matmul_ref, args,
                            max(5, iters // 4))
            lib = runs_ms(torch, lambda x, w, g: torch.bmm(x, w), args, iters)
            rows[name] = dict(ms=ms[0], plain_ms=plain[0], library_ms=lib[0],
                              bound_ms=b_ms, bound_by=b_by)
            log(f"timing[{gpu}] grouped_matmul {dt} {name} [{MOE_E}, {C}, "
                f"{D}] x [{MOE_E}, {D}, {F}] gs={gs.tolist()}: kernel "
                f"{ms[0]:.4f} ({ms[1]:.4f}-{ms[2]:.4f}) ms = "
                f"{flops / ms[0] / 1e9:.1f} TFLOP/s, plain {plain[0]:.4f} "
                f"({plain[1]:.4f}-{plain[2]:.4f}) ms, library (torch.bmm, "
                f"full buffers, product only) {lib[0]:.4f} ({lib[1]:.4f}-"
                f"{lib[2]:.4f}) ms, bound {b_ms:.4f} ms by {b_by} "
                f"({flops:.4g} flops, {nbytes} bytes)")
            del args
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# -- the training loop under amp O1 (Model.fit) -------------------------------
# F1: layernorm_residual at the mixed dtypes amp hands it, BERT-base's rows:
# (x, residual, weight / bias); O1 in bf16 gives the first two (layer 1's
# first LayerNorm takes the float32 embedding output as its residual, the
# other 23 a bf16 one), auto_cast(dtype="float16") the last two
LN_MIXES = (("bfloat16", "float32", "float32"),
            ("bfloat16", "bfloat16", "float32"),
            ("float16", "float32", "float32"),
            ("float16", "float16", "float32"))
LN_MIX_M, LN_MIX_D = BERT_B * BERT_S, 768
# F2: BERT-base pretraining through Model.fit under amp O1: 4 training
# batches and 1 evaluation batch of bench.py's shape, 2 epochs
FIT_BATCHES, FIT_EPOCHS = 4, 2
# F3: card vs CPU under O1, the first batch's gradient and two fit steps
# of PARITY_B rows: bf16 products round to 8 mantissa bits in other places
# on the two devices.  The limits are a few times the card's readings
# (PERF.md, PR 14): losses 3.6e-4 and 2.7e-5 apart, the gradient 1.65e-2
# (all parameters) and 1.59e-2 (kernel 2's LayerNorms) by relative L2
FIT_PARITY_RTOL = 2e-3
FIT_PARITY_GRAD_RTOL = 5e-2
# F4: a custom float16 loop with GradScaler; the step that gets an inf
F16_STEPS, F16_INF_STEP = 4, 2


def item_size(torch, dtype):
    return torch.finfo(getattr(torch, dtype)).bits // 8


def ln_mix_bound(torch, M, D, mix):
    """The forward's least time: x read (T), r read at its own width, s and
    y written (T), weight and bias read at their width, mean and rstd
    written, over the card's memory rate (operations as ``ln_bound``)."""
    tx, tr, tw = (item_size(torch, d) for d in mix)
    nbytes = M * D * (3 * tx + tr) + 2 * D * tw + 8 * M
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 8.0 * M * D / FP32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def ln_mix_bwd_bound(torch, M, D, mix, has_ds):
    """The backward's least time: s, dy (and ds_out) read and ds written in
    T, mean and rstd read, weight read and dg, db written at their width
    (it reads no residual)."""
    tx, tw = item_size(torch, mix[0]), item_size(torch, mix[2])
    nbytes = (3 + has_ds) * M * D * tx + 8 * M + 3 * D * tw
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 12.0 * M * D / FP32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def ln_mix_inputs(torch, mix, M, D, gen, n_copies=1):
    dt = [getattr(torch, d) for d in mix]
    g = (1 + 0.1 * torch.randn(D, generator=gen)).to(DEVICE, dt[2])
    b = (0.1 * torch.randn(D, generator=gen)).to(DEVICE, dt[2])
    return [(torch.randn(M, D, generator=gen).to(DEVICE, dt[0]),
             torch.randn(M, D, generator=gen).to(DEVICE, dt[1]), g, b)
            for _ in range(n_copies)]


def check_ln_mixed(torch, gpu):
    """Phase F1: ``layernorm_residual`` at each mix of LN_MIXES, BERT-base's
    [32768, 768]: both forward designs (s exact, y within phase 6's
    tolerance of x's dtype, two calls bit-equal) and both backward layouts
    with and without the s cotangent (``check_ln_bwd``: ds within the
    tolerance, dg / db scaled, in the weight's dtype, two calls
    bit-equal); then each mix's forward and backward device time by CUDA
    graph, inputs rotated past the L2, beside the plain versions, the
    bytes bounds (each operand at its own width) and
    ``F.layer_norm(x + r, (D,), g, b)`` on the same dtypes where torch
    takes them (not a bf16 / f16 sum beside float32 g / b).  Returns
    ``{mix: row}`` for the kernels record."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_layernorm as fl

    gen = torch.Generator().manual_seed(SEED + 140)
    M, D = LN_MIX_M, LN_MIX_D
    rows = {}
    for mix in LN_MIXES:
        name = "/".join(mix)
        tol = ln_tol(mix[0])
        (x, r, g, b), = ln_mix_inputs(torch, mix, M, D, gen)
        dts = tuple(t.dtype for t in (x, r, g))
        fplan = fl._forward_plan(dts, D, True)
        bplan = fl._backward_plan((dts[0], dts[2]), D, True)
        assert (fplan, bplan) == ("vector", "vector"), (mix, fplan, bplan)
        s0, y0, mean0, rstd0 = fl._forward_ref(x, r, g, b, 1e-12)
        if mix[0] == "float16":
            # the tolerance must catch y rounded through bf16 on its way
            try:
                torch.testing.assert_close(
                    y0.to(torch.bfloat16).to(y0.dtype), y0, **tol)
            except AssertionError:
                pass
            else:
                raise AssertionError(f"{mix}: float16's tolerance passes "
                                     f"a y rounded through bf16")
        err = None
        for design in ("vector", "first"):
            got = fl._forward_kernel(x, r, g, b, 1e-12, design=design)
            again = fl._forward_kernel(x, r, g, b, 1e-12, design=design)
            torch.cuda.synchronize()
            assert all(torch.equal(a, c) for a, c in zip(got, again)), \
                ("layernorm_residual: two calls differ", mix, design)
            assert torch.equal(got[0], s0), ("s differs", mix, design)
            assert got[0].dtype == got[1].dtype == dts[0]
            torch.testing.assert_close(got[1], y0, **tol)
            torch.testing.assert_close(got[2], mean0, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(got[3], rstd0, rtol=1e-5, atol=1e-5)
            e = float((got[1].float() - y0.float()).abs().max())
            err = e if err is None else err
            log(f"F1 layernorm_residual {name} [{M}, {D}] forward {design}: "
                f"s exact, y max_abs_err={e:.3e} (rtol={tol['rtol']}, "
                f"atol={tol['atol']}), two calls bit-equal; ok")
        dy, ds = (torch.randn(M, D, generator=gen).to(DEVICE, dts[0])
                  for _ in range(2))
        bwd_err = 0.0
        for design in ("vector", "scalar"):
            for ds_out in (ds, None):
                e = check_ln_bwd(torch, fl, s0, mean0, rstd0, g, dy, ds_out,
                                 tol, design=design)
                bwd_err = max(bwd_err, e) if design == "vector" else bwd_err
                log(f"F1 layernorm_residual {name} [{M}, {D}] backward "
                    f"{design}, {'with' if ds_out is not None else 'without'}"
                    f" the s cotangent: ds max_abs_err={e:.3e}, dg / db "
                    f"{g.dtype} within the tolerance of their largest "
                    f"magnitude; two calls bit-equal; ok")
        del x, r, dy, ds, s0, y0
        # timing, as phase 10 times row 2
        args = ln_mix_inputs(torch, mix, M, D, gen, n_copies=ln_copies(
            M, D, 2))
        fwd = lambda *a: fl._forward_kernel(*a, 1e-12)  # noqa: E731
        with torch.no_grad():
            ms = graph_ms(torch, fwd, args, 100)
            first = graph_ms(torch, lambda *a: fl._forward_kernel(
                *a, 1e-12, design="first"), args, 100)
            plain = graph_ms(torch, lambda *a: fl._forward_ref(*a, 1e-12),
                             args, 20)
            # torch's layer_norm takes its weight in its input's dtype only:
            # no library call for a bf16 / f16 sum beside float32 g / b
            lib = (graph_ms(torch, lambda x, r, g, b: F.layer_norm(
                x + r, (D,), g, b, 1e-12), args, 50)
                if torch.promote_types(dts[0], dts[1]) == dts[2] else None)
            bargs = []
            for x, r, g, b in args:
                s, _, mean, rstd = fl._forward_kernel(x, r, g, b, 1e-12)
                bargs.append((s, mean, rstd, g, None, torch.randn(
                    M, D, generator=gen).to(DEVICE, s.dtype)))
            del args
            bms = graph_ms(torch, fl._backward_kernel, bargs, 50)
            bplain = graph_ms(torch, fl._backward_ref, bargs, 10)
            del bargs
        b_ms, b_by = ln_mix_bound(torch, M, D, mix)
        bb_ms, bb_by = ln_mix_bwd_bound(torch, M, D, mix, False)
        lib_text = ("none (torch takes no float32 weight beside a bf16 / "
                    "f16 input)" if lib is None else f"{lib:.4f}")
        log(f"timing[{gpu}] F1 layernorm_residual {name} [{M}, {D}] forward"
            f" (vector): device {ms:.4f} ms ({100 * b_ms / ms:.0f}% of the "
            f"bound), first design {first:.4f}, plain {plain:.4f}, library "
            f"(layer_norm(x + r) on these dtypes) {lib_text}, bound "
            f"{b_ms:.4f} ms by {b_by}")
        log(f"timing[{gpu}] F1 layernorm_residual {name} [{M}, {D}] backward"
            f" (vector, without the s cotangent, as BERT runs it): device "
            f"{bms:.4f} ms ({100 * bb_ms / bms:.0f}% of the bound), plain "
            f"{bplain:.4f}, bound {bb_ms:.4f} ms by {bb_by}")
        rows[name] = dict(ms=ms, first_design_ms=first, plain_ms=plain,
                          library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                          max_abs_err=err, backward=dict(
                              ms=bms, plain_ms=bplain, library_ms=None,
                              bound_ms=bb_ms, bound_by=bb_by,
                              max_abs_err=bwd_err))
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def fit_data(torch, io, cfg, n_batches, B, seed):
    """``n_batches`` x ``B`` rows of ``bert_batch`` data as one
    ``io.TensorDataset`` (inputs, then labels)."""
    inputs, labels = bert_batch(cfg.vocab_size, n_batches * B, BERT_S,
                                BERT_P, seed=seed)
    return io.TensorDataset(inputs + labels), inputs, labels


def bert_fit_model(torch, ptt, device, cfg, seed_or_gen):
    from paddle_tpu_torch.models import BertForPretraining

    if isinstance(seed_or_gen, int):
        ptt.seed(seed_or_gen)
        net = BertForPretraining(cfg, device=device)
    else:
        net = BertForPretraining(cfg, device=device, generator=seed_or_gen)
    model = ptt.Model(net, ["input_ids", "token_type_ids", "attention_mask",
                            "masked_positions"],
                      ["mlm_labels", "nsp_labels"]).prepare(
        optimizer=ptt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01),
        loss=net.loss, amp_configs="O1")
    return model, net


class _FitProbe:
    """Zeroes the kernel counts and starts the clock when epoch 1 begins,
    stops the clock when its training ends, reads the counts when fit
    ends (after epoch 1's evaluation); keeps every training loss (a 0-d
    device tensor, read after fit)."""

    def __init__(self, torch, counters):
        self.torch, self.counters = torch, counters
        self.losses, self.t0, self.t1, self.counts = [], None, None, None

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_epoch_begin(self, epoch, logs=None):
        if epoch == FIT_EPOCHS - 1:
            self.torch.cuda.synchronize()
            for c in self.counters:
                c.launches = 0
                if hasattr(c, "backward_launches"):
                    c.backward_launches = 0
            self.t0 = time.monotonic()

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])

    def on_epoch_end(self, epoch, logs=None):
        if epoch == FIT_EPOCHS - 1:
            self.torch.cuda.synchronize()
            self.t1 = time.monotonic()

    def on_train_end(self, logs=None):
        self.torch.cuda.synchronize()
        if self.counters:
            self.counts = [c.launches for c in self.counters] + [
                self.counters[0].backward_launches]

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)


def fit_bert(torch, gpu):
    """Phase F2, this slice's main path: ``BertForPretraining(bert_base())``
    with float32 parameters and dropout 0.1, ``prepare(AdamW(1e-4,
    weight_decay=0.01), net.loss, amp_configs="O1")``, ``fit`` over 4
    seeded batches of 256 x 128 (20 masked) for 2 epochs, shuffled,
    evaluating on a fifth batch after each epoch, with ``ModelCheckpoint``
    and ``LRScheduler``; the counts are zeroed when epoch 2 begins and read
    when fit ends: ``layernorm_residual`` 24 x (train steps + eval
    batches) forward, 24 x train steps backward, ``softmax_cross_entropy``
    train steps + eval batches.  Losses finite, epoch 2's mean below epoch
    1's; the checkpoint files present; the checkpoint loaded into a fresh
    model and optimizer on the card gives ``evaluate`` a loss bit-equal to
    the trained model's, and ``predict`` MLM logits in float32 of the
    right shapes.  Prints seq/s of fit's second epoch beside
    ``train_batch`` over the same batches (the loop's host cost is the
    difference), checkpoint save / load seconds and size, and peak device
    memory."""
    import shutil
    import tempfile

    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import io
    from paddle_tpu_torch.hapi.callbacks import LRScheduler, ModelCheckpoint
    from paddle_tpu_torch.models import bert_base
    from paddle_tpu_torch.ops import layernorm_residual, softmax_cross_entropy

    cfg = bert_base()
    t0 = time.monotonic()
    model, net = bert_fit_model(torch, ptt, DEVICE, cfg, SEED)
    train, tin, tlab = fit_data(torch, io, cfg, FIT_BATCHES, BERT_B,
                                SEED + 150)
    evald, ein, elab = fit_data(torch, io, cfg, 1, BERT_B, SEED + 151)
    log(f"F2 fit[bert]: bert_base f32 parameters, dropout {cfg.dropout}, "
        f"amp O1, {FIT_BATCHES} x {BERT_B}x{BERT_S} training rows "
        f"({BERT_P} masked), 1 evaluation batch, built in "
        f"{time.monotonic() - t0:.1f}s")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    try:
        probe = _FitProbe(torch, (layernorm_residual,
                                  softmax_cross_entropy))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        model.fit(train, eval_data=evald, batch_size=BERT_B,
                  epochs=FIT_EPOCHS, shuffle=True, verbose=0,
                  callbacks=[probe, ModelCheckpoint(save_dir=ckpt),
                             LRScheduler()])
        fit_s = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = [float(v) for v in probe.losses]
        ln, sx, lnb = probe.counts
        log(f"F2 fit[bert]: losses {[round(v, 4) for v in losses]}")
        log(f"F2 fit[bert]: launches over epoch {FIT_EPOCHS} and its "
            f"evaluation: layernorm_residual {ln} (= 24 x ({FIT_BATCHES} + "
            f"1): {ln == 24 * (FIT_BATCHES + 1)}), backward {lnb} (= 24 x "
            f"{FIT_BATCHES}: {lnb == 24 * FIT_BATCHES}), "
            f"softmax_cross_entropy {sx} (= {FIT_BATCHES} + 1: "
            f"{sx == FIT_BATCHES + 1})")
        assert ln == 2 * cfg.num_layers * (FIT_BATCHES + 1), ln
        assert lnb == 2 * cfg.num_layers * FIT_BATCHES, lnb
        assert sx == FIT_BATCHES + 1, sx
        assert len(losses) == FIT_EPOCHS * FIT_BATCHES
        assert all(math.isfinite(v) for v in losses), losses
        e1 = sum(losses[:FIT_BATCHES]) / FIT_BATCHES
        e2 = sum(losses[FIT_BATCHES:]) / FIT_BATCHES
        assert e2 < e1, (e1, e2)
        files = sorted(os.listdir(ckpt))
        want = sorted(f"{t}.{ext}" for t in [*map(str, range(FIT_EPOCHS)),
                                             "final"]
                      for ext in ("pdparams", "pdopt"))
        assert files == want, files
        epoch_s = probe.t1 - probe.t0
        fit_sps = FIT_BATCHES * BERT_B / epoch_s
        trained = model.evaluate(evald, batch_size=BERT_B, verbose=0)
        # the same batches through train_batch (a wait for the card each
        # step), after one untimed step
        model.train_batch([a[:BERT_B] for a in tin],
                          [a[:BERT_B] for a in tlab])
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for i in range(FIT_BATCHES):
            sl = slice(i * BERT_B, (i + 1) * BERT_B)
            model.train_batch([a[sl] for a in tin], [a[sl] for a in tlab])
        torch.cuda.synchronize()
        tb_sps = FIT_BATCHES * BERT_B / (time.monotonic() - t0)
        path = os.path.join(ckpt, "again")
        t0 = time.monotonic()
        model.save(path)
        save_s = time.monotonic() - t0
        size = sum(os.path.getsize(path + ext)
                   for ext in (".pdparams", ".pdopt"))
        # the final checkpoint in a fresh model and optimizer on the card
        fresh, fnet = bert_fit_model(torch, ptt, DEVICE, cfg, SEED + 1)
        t0 = time.monotonic()
        fresh.load(os.path.join(ckpt, "final"))
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        reloaded = fresh.evaluate(evald, batch_size=BERT_B, verbose=0)
        log(f"F2 fit[bert]: evaluate loss trained {trained['loss']!r} vs "
            f"reloaded {reloaded['loss']!r} (bit-equal: "
            f"{trained['loss'] == reloaded['loss']})")
        assert reloaded["loss"] == trained["loss"], (trained, reloaded)
        assert fresh._optimizer.state_dict()["count"] == \
            FIT_EPOCHS * FIT_BATCHES
        n_pred = min(32, BERT_B)
        out = fresh.predict(io.TensorDataset([a[:n_pred] for a in ein]),
                            batch_size=n_pred)
        (mlm, nsp), = out
        assert mlm.shape == (n_pred, BERT_P, cfg.vocab_size) and \
            mlm.dtype == np.float32, (mlm.shape, mlm.dtype)
        assert nsp.shape == (n_pred, 2) and np.isfinite(mlm).all()
        log(f"F2 predict: mlm logits {mlm.shape} {mlm.dtype}, nsp "
            f"{nsp.shape} {nsp.dtype}; ok")
        log(f"F2 fit[bert][{gpu}]: epoch {FIT_EPOCHS} trained in "
            f"{epoch_s:.3f}s = {epoch_s / FIT_BATCHES * 1e3:.1f} ms/step, "
            f"{fit_sps:.1f} seq/s through fit; train_batch over the same "
            f"batches {tb_sps:.1f} seq/s ({BERT_B / tb_sps * 1e3:.1f} "
            f"ms/step); the whole fit {fit_s:.1f}s with 3 checkpoints; "
            f"save {save_s:.2f}s, load {load_s:.2f}s, checkpoint "
            f"{size / 2**20:.0f} MiB (.pdparams + .pdopt); peak device "
            f"memory {peak / 2**20:.0f} MiB")
        del fresh, fnet
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del model, net
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {"layernorm_residual": ln,
                         "layernorm_residual_backward": lnb,
                         "softmax_cross_entropy": sx},
            "fit_seq_per_s": fit_sps, "train_batch_seq_per_s": tb_sps,
            "save_s": save_s, "load_s": load_s, "checkpoint_bytes": size,
            "peak_bytes": peak}


def fit_card_vs_cpu(torch, cfg=None):
    """Phase F3: ``bert_base()`` f32 with dropout 0 from one seeded init,
    on the card (kernels) and on the CPU (plain versions), under amp O1:
    first the gradient of the first batch through the model's own O1
    forward and loss, held by its relative L2 difference over all
    parameters and over the 24 LayerNorms kernel 2 runs (its dg / db; a
    wrong ds shows in every parameter below it) against
    FIT_PARITY_GRAD_RTOL; then two ``fit`` steps of PARITY_B rows with
    ``shuffle=False``, the losses at FIT_PARITY_RTOL."""
    import re

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import io
    from paddle_tpu_torch.models import bert_base

    cfg = cfg or bert_base(dropout=0.0)
    train, tin, tlab = fit_data(torch, io, cfg, 2, PARITY_B, SEED + 152)
    losses, grads = {}, {}
    for dev in (DEVICE, "cpu"):
        model, net = bert_fit_model(torch, ptt, dev, cfg,
                                    torch.Generator().manual_seed(SEED))
        net.train()
        loss, _, _ = model._forward_loss(model._batch(
            [a[:PARITY_B] for a in tin], [a[:PARITY_B] for a in tlab]))
        loss.backward()
        grads[dev] = {n: p.grad.detach().double().cpu()
                      for n, p in net.named_parameters()
                      if p.grad is not None}
        model._optimizer.clear_grad()
        probe = _FitProbe(torch, ())
        model.fit(train, batch_size=PARITY_B, epochs=1, shuffle=False,
                  verbose=0, callbacks=[probe])
        losses[dev] = [float(v) for v in probe.losses]
        del model, net
    assert grads[DEVICE].keys() == grads["cpu"].keys()
    ln = [n for n in grads["cpu"] if re.search(r"\.ln[12]\.", n)]
    assert len(ln) == 4 * cfg.num_layers, ln
    rel = {}
    for group, names in (("all", list(grads["cpu"])), ("kernel 2", ln)):
        got = torch.cat([grads[DEVICE][n].flatten() for n in names])
        want = torch.cat([grads["cpu"][n].flatten() for n in names])
        rel[group] = float((got - want).norm() / want.norm())
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses[DEVICE],
                                                 losses["cpu"])]
    log(f"F3 parity: bert_base f32 parameters under amp O1, batch "
        f"{PARITY_B}x{BERT_S}: the first batch's gradient card vs cpu, "
        f"relative L2 difference {rel['all']:.3e} over all parameters, "
        f"{rel['kernel 2']:.3e} over the {len(ln)} LayerNorm weights / "
        f"biases of kernel 2 (<= {FIT_PARITY_GRAD_RTOL}); 2 fit steps: "
        f"card {losses[DEVICE]} vs cpu {losses['cpu']}, rel diff {gaps} "
        f"(<= {FIT_PARITY_RTOL})")
    assert all(v <= FIT_PARITY_GRAD_RTOL for v in rel.values()), rel
    assert len(losses[DEVICE]) == len(losses["cpu"]) == 2
    for a, b in zip(losses[DEVICE], losses["cpu"]):
        assert abs(a - b) <= FIT_PARITY_RTOL * abs(b), (a, b)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return losses, rel


def f16_scaler_loop(torch, gpu):
    """Phase F4: a custom loop — BERT-base with float32 parameters under
    ``amp.auto_cast(dtype="float16")`` with ``amp.GradScaler(
    init_loss_scaling=2**15, decr_every_n_nan_or_inf=1)``, AdamW, 4 steps
    on F2's batches; kernel 2 runs in float16 ((f16, f32, f32) and (f16,
    f16, f32)), 24 launches a step forward and backward.  Step 3's
    gradients get an inf: the step is skipped (every parameter
    bit-equal, the optimizer's count unchanged) and the scale halves
    (2**15 → 2**14, counters reset), as the state machine says; the other
    steps' losses are finite."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import BertForPretraining, bert_base
    from paddle_tpu_torch.ops import layernorm_residual

    cfg = bert_base()
    ptt.seed(SEED)
    net = BertForPretraining(cfg, device=DEVICE)
    opt = ptt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                              parameters=dict(net.named_parameters()))
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15,
                            decr_every_n_nan_or_inf=1)
    inputs, labels = bert_batch(cfg.vocab_size, F16_STEPS * BERT_B, BERT_S,
                                BERT_P, seed=SEED + 150)
    layernorm_residual.launches = 0
    layernorm_residual.backward_launches = 0
    scales, losses = [], []
    net.train()
    for step in range(F16_STEPS):
        sl = slice(step * BERT_B, (step + 1) * BERT_B)
        batch = [torch.as_tensor(a[sl], device=DEVICE) for a in inputs]
        labs = [torch.as_tensor(a[sl], device=DEVICE) for a in labels]
        with amp.auto_cast(level="O1", dtype="float16"):
            out = net(*batch)
            loss = net.loss(*out, *labs)
        assert out[0].dtype == torch.float32  # the black-listed ln: f32
        scaler.scale(loss).backward()
        if step == F16_INF_STEP:
            p = net.bert.layers[0].attn.qkv.weight
            p.grad[0, 0] = float("inf")
            before = [q.detach().clone() for q in net.parameters()]
            count = opt.state_dict()["count"]
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        if step == F16_INF_STEP:
            assert all(torch.equal(a, q) for a, q in zip(
                before, net.parameters())), "the inf step updated"
            assert opt.state_dict()["count"] == count
            del before
        scales.append(scaler.get_loss_scaling())
        losses.append(loss.item())
    torch.cuda.synchronize()
    ln, lnb = (layernorm_residual.launches,
               layernorm_residual.backward_launches)
    log(f"F4 float16 loop[{gpu}]: losses {[round(v, 4) for v in losses]}, "
        f"loss scale after each step {scales}, skipped steps "
        f"{scaler._skipped_steps}; layernorm_residual launches {ln} / "
        f"backward {lnb} (= 24 x {F16_STEPS}: "
        f"{ln == lnb == 24 * F16_STEPS})")
    assert scales == [2.0 ** 15] * F16_INF_STEP + [2.0 ** 14] * (
        F16_STEPS - F16_INF_STEP), scales
    assert scaler._skipped_steps == 1
    assert int(scaler.state_dict()["bad_steps"]) == 0
    assert all(math.isfinite(v) for v in losses), losses
    assert ln == lnb == 2 * cfg.num_layers * F16_STEPS, (ln, lnb)
    del net, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": ln, "backward_launches": lnb, "scales": scales}


# -- sparse CTR training: SelectedRows, WideDeep, the native ingest ----------
# S1: a million-row table, one batch of 2048 ids (256 x 8) that repeats the
# hot ids and holds the padding id.  Each rule takes one step on the card
# (twice) and on the CPU from one init: the touched rows at rtol 1e-6 /
# atol 1e-6 (the tables are O(1); the card's and the CPU's products sum
# the dense layer in other orders); the bf16 table's float32 master at
# lr * 2^-7, since its rows' gradients are bf16 and may round one step
# apart, which Adam's normalized step turns into up to lr * 2^-7
CTR_VOCAB, CTR_DIM = 1_000_000, 32
S1_B, S1_F, S1_PAD = 256, 8, 0
S1_CASES = {  # name -> (factory(optimizer module), table dtype, rows only)
    "sgd": (lambda o: o.SGD(0.5), "float32", True),
    "momentum": (lambda o: o.Momentum(0.1, momentum=0.9), "float32", True),
    "adagrad": (lambda o: o.Adagrad(0.1), "float32", True),
    "ftrl": (lambda o: o.Ftrl(0.1, l1=1e-4, l2=0.01), "float32", True),
    "adam_lazy": (lambda o: o.Adam(0.1, lazy_mode=True), "float32", True),
    "adam_dense": (lambda o: o.Adam(0.1), "float32", False),
    "adamw_lazy_decay": (lambda o: o.AdamW(0.1, weight_decay=0.5,
                                           lazy_mode=True), "float32", True),
    "lamb_dense": (lambda o: o.Lamb(0.01), "float32", False),
    "adam_lazy_clip_global_norm": (lambda o: o.Adam(
        0.1, lazy_mode=True, grad_clip=o.ClipGradByGlobalNorm(1e-3)),
        "float32", True),
    "adam_lazy_multi_precision_bf16": (lambda o: o.Adam(
        0.1, lazy_mode=True, multi_precision=True), "bfloat16", True),
}
# S2, the slice's main path: examples/sparse_ctr_training.py's WideDeep at a
# million ids, fed by InMemoryDataset from seeded text files (bench.py's
# latent-logit clicks on slot 0 and the dense features)
S2_FIELDS, S2_DENSE, S2_EMBED, S2_HIDDEN = 8, 8, 32, (64, 32)
S2_ROWS, S2_FILES, S2_THREADS, S2_B = 51200, 8, 8, 256
S2_HELDOUT, S2_TIMED_FROM = 4096, 20
# S3: bench.py's config 5 (bench_ctr): wide_deep_tiny(sparse=True),
# Adam(1e-2, lazy_mode=True), 120 steps on 4096 rows; its AUC gate
S3_N, S3_STEPS, CTR_AUC_GATE = 4096, 120, 0.8
# S4: tools/bench_sparse_embedding.py's net and its pass rule
S4_VOCABS, S4_DIM, S4_B, S4_F = (10 ** 5, 10 ** 6, 10 ** 7), 64, 256, 4
S4_WARMUP, S4_ITERS, S4_RATIO = 3, 20, 2.0


def _ctr_net_class():
    """The one-table net of S1 / S4: ``Embedding(sparse=True)`` → mean over
    the fields → ``Linear(dim, 1)``."""
    from paddle_tpu_torch import nn

    class Net(nn.Layer):
        def __init__(self, vocab, dim, sparse=True, padding_idx=None):
            super().__init__()
            self.emb = nn.Embedding(vocab, dim, padding_idx=padding_idx,
                                    sparse=sparse)
            self.fc = nn.Linear(dim, 1)

        def forward(self, ids):
            return self.fc(self.emb(ids).mean(1).float())

    return Net


def _mse(out, y):
    return ((out - y) ** 2).mean()


def sparse_rules_card_vs_cpu(torch):
    """Phase S1: every sparse rule, one step on the card twice and on the
    CPU, from one init drawn on the CPU (see S1_CASES).  Gates: touched
    rows and the dense layer at the stated tolerance; the padding row, and
    in row mode every row the batch did not touch (and its slots),
    bit-unchanged; the two card runs bit-equal, table and slots; the
    global-norm clip's norm over a batch of repeated ids equal to the
    merged rows' norm (float64 over the dense scatter, rtol 1e-6) and not
    the unmerged stack's."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.framework.selected_rows import (SelectedRows,
                                                          sparse_tape)
    from paddle_tpu_torch.optimizer.clip import _sq_norm

    Net = _ctr_net_class()
    ptt.seed(SEED)
    init = Net(CTR_VOCAB, CTR_DIM, padding_idx=S1_PAD)
    init.emb.reset_parameters(torch.Generator().manual_seed(SEED))
    init.fc.reset_parameters(torch.Generator().manual_seed(SEED + 1))
    state = {k: v.detach() for k, v in init.state_dict().items()}
    rng = np.random.RandomState(SEED + 300)
    ids = rng.randint(0, CTR_VOCAB, (S1_B, S1_F)).astype(np.int64)
    ids[:, :3] = rng.randint(0, 64, (S1_B, 3))   # hot ids, repeated
    ids[rng.rand(S1_B, S1_F) < 0.1] = S1_PAD
    y = rng.randn(S1_B, 1).astype(np.float32)
    touched = np.setdiff1d(np.unique(ids), [S1_PAD])
    untouched = torch.ones(CTR_VOCAB, dtype=torch.bool, device=DEVICE)
    untouched[torch.from_numpy(np.unique(ids)).to(DEVICE)] = False
    assert len(touched) < S1_B * S1_F  # the batch repeats ids

    def one_step(case, device):
        make, dtype, _ = S1_CASES[case]
        net = Net(CTR_VOCAB, CTR_DIM, padding_idx=S1_PAD).to(device)
        net.load_state_dict(state)
        net.emb.to(getattr(torch, dtype))
        model = ptt.Model(net, inputs=["ids"], labels=["y"])
        model.prepare(optimizer=make(popt), loss=_mse)
        loss = model.train_batch([ids], [y])[0]
        return net, model._optimizer._state["slots"], loss

    results = {}
    t0 = time.monotonic()
    for case, (make, dtype, rows_only) in S1_CASES.items():
        cpu, cpu_slots, cpu_loss = one_step(case, "cpu")
        card, card_slots, card_loss = one_step(case, DEVICE)
        again, again_slots, _ = one_step(case, DEVICE)
        w, w2 = card.emb.weight.detach(), again.emb.weight.detach()
        assert torch.equal(w, w2), f"S1 {case}: two card runs differ"
        for name, slots in card_slots.items():
            for s, v in slots.items():
                assert torch.equal(v, again_slots[name][s]), (case, name, s)
        w0 = state["emb.weight"].to(DEVICE).to(w.dtype)
        assert torch.equal(w[S1_PAD], w0[S1_PAD]), f"S1 {case}: padding row"
        if case != "lamb_dense":  # Lamb's decay moves every row
            assert torch.equal(w[untouched], w0[untouched]), \
                f"S1 {case}: untouched rows moved"
        if rows_only:
            for s, v in card_slots["emb.weight"].items():
                if s != "master":
                    assert not bool(v[untouched].any()), (case, s)
        lr = S1_CASES[case][0](popt).get_lr()
        if dtype == "float32":
            got, ref = w[touched].cpu(), cpu.emb.weight.detach()[touched]
            tol = dict(rtol=1e-6, atol=1e-6)
        else:
            got = card_slots["emb.weight"]["master"][touched].cpu()
            ref = cpu_slots["emb.weight"]["master"][touched]
            tol = dict(rtol=1e-6, atol=lr * 2 ** -7)
            assert torch.equal(w, card_slots["emb.weight"]["master"].to(
                w.dtype)), "S1: bf16 table != its master rounded"
        err = (got.float() - ref.float()).abs()
        bad = err > tol["atol"] + tol["rtol"] * ref.float().abs()
        assert not bool(bad.any()), \
            f"S1 {case}: touched rows {float(err.max()):.3e} from the CPU"
        for k in ("fc.weight", "fc.bias"):
            torch.testing.assert_close(
                dict(card.named_parameters())[k].detach().cpu(),
                dict(cpu.named_parameters())[k].detach(), rtol=1e-5,
                atol=1e-6)
        assert abs(card_loss - cpu_loss) <= 1e-5 * abs(cpu_loss), case
        results[case] = float(err.max())
        del cpu, card, again, cpu_slots, card_slots, again_slots
    # the clip's norm over repeated ids: the merged rows', not the stack's
    net = Net(CTR_VOCAB, CTR_DIM, padding_idx=S1_PAD).to(DEVICE)
    net.load_state_dict(state)
    net.emb.weight.requires_grad_(False)
    with sparse_tape() as tape:
        loss = _mse(net(torch.from_numpy(ids).to(DEVICE)),
                    torch.from_numpy(y).to(DEVICE))
    (_, tap_ids, delta), = tape.taps
    (gd,) = torch.autograd.grad(loss, [delta])
    sr = SelectedRows(tap_ids, gd, CTR_VOCAB)
    merged = float(_sq_norm(sr))
    dense = float(sr.to_dense().double().square().sum())
    stack = float(sr.l2_norm_sq())
    assert abs(merged - dense) <= 1e-6 * dense, (merged, dense)
    assert abs(stack - dense) > 1e-3 * dense, "S1: no repeated ids"
    clipped = popt.ClipGradByGlobalNorm(1e-3)({"emb": sr})["emb"]
    assert abs(math.sqrt(float(_sq_norm(clipped))) - 1e-3) < 1e-8
    torch.cuda.synchronize()
    log(f"S1 sparse rules card vs CPU: {len(touched)} touched rows of "
        f"{CTR_VOCAB} (2048 ids, padding {int((ids == S1_PAD).sum())}); "
        f"largest touched-row error against the CPU by rule "
        f"{ {k: f'{v:.2e}' for k, v in results.items()} }; untouched and "
        f"padding rows bit-unchanged, two card runs bit-equal; clip norm^2 "
        f"merged {merged:.6e} = dense {dense:.6e} (the unmerged stack "
        f"{stack:.6e}); {time.monotonic() - t0:.1f}s")
    del net, tape, sr, init, state
    gc.collect()
    torch.cuda.empty_cache()
    return results


def _ctr_clicks(np, n, rng, table, w_dense, fields, dense):
    """bench.py:367-372's clicks: Bernoulli draws from the latent logit
    2 (table[id of slot 0] + dense . w_dense)."""
    ids = rng.randint(0, len(table), size=(n, fields)).astype(np.int64)
    xd = rng.randn(n, dense).astype(np.float32)
    s = 2.0 * (table[ids[:, 0]] + xd @ w_dense)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-s))).astype(np.float32)
    return ids, xd, y[:, None]


def ctr_dataset(np):
    """S2's data: 51,200 seeded clicks (8 id slots in [0, 1M), 8 dense
    features, a click) written to 8 text files and loaded by
    ``InMemoryDataset`` with 8 threads, then ``global_shuffle(seed)``; and
    4096 held-out rows.  Returns (dataset, held-out arrays, rows loaded,
    load seconds)."""
    import shutil
    import tempfile

    from paddle_tpu_torch.io import InMemoryDataset

    rng = np.random.RandomState(SEED + 400)
    table = rng.randn(CTR_VOCAB)
    w_dense = rng.randn(S2_DENSE) * 0.5
    ids, xd, y = _ctr_clicks(np, S2_ROWS, rng, table, w_dense, S2_FIELDS,
                             S2_DENSE)
    held = _ctr_clicks(np, S2_HELDOUT, np.random.RandomState(SEED + 401),
                       table, w_dense, S2_FIELDS, S2_DENSE)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ctr_")
    try:
        files = []
        fmt = ["%d"] * S2_FIELDS + ["%.6f"] * S2_DENSE + ["%d"]
        rows = np.concatenate([ids, xd, y], 1)
        for i, part in enumerate(np.array_split(rows, S2_FILES)):
            files.append(os.path.join(tmp, f"part-{i}.txt"))
            np.savetxt(files[-1], part, fmt=fmt)
        ds = InMemoryDataset(slots=[("sparse", S2_FIELDS, "int64"),
                                    ("dense", S2_DENSE, "float32"),
                                    ("label", 1, "float32")])
        ds.set_filelist(files)
        t0 = time.perf_counter()
        n = ds.load_into_memory(thread_num=S2_THREADS)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert n == S2_ROWS, n
    ds.global_shuffle(seed=SEED)
    return ds, held, n, load_s


def ctr_main_path(torch, gpu):
    """Phase S2, the slice's main path: ``WideDeep(num_fields=8,
    vocab_size=1_000_000, embed_dim=32, dense_dim=8, hidden_sizes=(64,
    32), sparse=True)`` with ``Model.prepare(Adam(1e-3, lazy_mode=True),
    net.loss)``, fed by ``InMemoryDataset`` from 8 seeded text files
    (51,200 rows: 8 id slots in [0, 1M), 8 dense features, a click) loaded
    by 8 threads, ``global_shuffle(seed)``, ``batch_iter(256)`` into
    ``train_batch`` for 200 steps.  Gates: losses finite, the mean of the
    last 50 below the first 50's; every row of both tables whose id was
    never drawn bit-equal to its init; ``predict_batch`` on 4096 held-out
    rows gives probabilities in (0, 1).  Prints the load seconds, the
    median step over steps 20-200 (each synchronized by its loss), samples/s
    and peak device memory."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import WideDeep

    ds, held, n, load_s = ctr_dataset(np)
    ptt.seed(SEED)
    net = WideDeep(num_fields=S2_FIELDS, vocab_size=CTR_VOCAB,
                   embed_dim=S2_EMBED, dense_dim=S2_DENSE,
                   hidden_sizes=S2_HIDDEN, sparse=True)
    assert net.device.type == torch.device(DEVICE).type  # the default
    model = ptt.Model(net, inputs=["sparse", "dense"], labels=["label"])
    model.prepare(optimizer=ptt.optimizer.Adam(1e-3, lazy_mode=True),
                  loss=net.loss)
    w0 = {k: getattr(net, k).weight.detach().clone()
          for k in ("embedding", "wide")}
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, drawn = [], [], []
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for sparse, dense, label in ds.batch_iter(S2_B):
        drawn.append(sparse)
        t0 = time.perf_counter()
        losses.append(model.train_batch([sparse, dense], [label])[0])
        step_s.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_all
    peak = torch.cuda.max_memory_allocated()
    steps = len(losses)
    assert steps == S2_ROWS // S2_B, steps
    assert all(math.isfinite(v) for v in losses), losses
    first, last = np.mean(losses[:50]), np.mean(losses[-50:])
    assert last < first, (first, last)
    seen = torch.zeros(CTR_VOCAB, dtype=torch.bool, device=DEVICE)
    seen[torch.from_numpy(np.unique(np.concatenate(drawn))).to(DEVICE)] = True
    for k, w in w0.items():
        now = getattr(net, k).weight.detach()
        assert torch.equal(now[~seen], w[~seen]), f"S2: {k} rows moved"
        assert not torch.equal(now[seen], w[seen]), f"S2: {k} never trained"
    # the sparse step never waits for the card: a batch already on it
    # goes through train_batch's device half with CUDA's sync check on
    staged = model._batch([held[0][:S2_B], held[1][:S2_B]],
                          [held[2][:S2_B]])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model._train_batch_device(list(staged[:2]), [staged[2]])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    prob = net.predict_proba(model.predict_batch([held[0], held[1]]))
    assert prob.shape == (S2_HELDOUT, 1)
    assert bool(((prob > 0) & (prob < 1)).all()), "S2: probabilities"
    med = float(np.median(step_s[S2_TIMED_FROM:]))
    out = {"load_s": load_s, "step_ms": med * 1e3,
           "samples_per_s": S2_B / med, "peak_bytes": peak,
           "steps": steps, "wall_s": wall, "first50": float(first),
           "last50": float(last), "never_drawn": int((~seen).sum())}
    log(f"S2 sparse CTR main path[{gpu}]: {n} rows from {S2_FILES} files "
        f"loaded by {S2_THREADS} threads in {load_s:.3f}s; {steps} steps of "
        f"{S2_B}: median step {med * 1e3:.3f} ms (steps {S2_TIMED_FROM}-"
        f"{steps}, p10-p90 {np.percentile(step_s[S2_TIMED_FROM:], 10) * 1e3:.3f}"
        f"-{np.percentile(step_s[S2_TIMED_FROM:], 90) * 1e3:.3f}), "
        f"{S2_B / med:.0f} samples/s, wall {wall:.2f}s; loss first 50 "
        f"{first:.4f} -> last 50 {last:.4f}; {out['never_drawn']} never-drawn "
        f"rows bit-equal to the init; peak device memory "
        f"{peak / 2 ** 20:.0f} MiB")
    del net, model, w0, seen
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ctr_bench_config5(torch, gpu):
    """Phase S3, ``bench.py``'s config 5 as ``bench_ctr`` runs it:
    ``wide_deep_tiny(sparse=True)``, ``Adam(1e-2, lazy_mode=True)``, 120
    ``train_batch`` steps on 4096 rows, the AUC (``metric.Auc``) of the
    held-out rows' probabilities.  Gates: AUC >= ``CTR_AUC_GATE`` (0.8,
    bench.py:68); the same run on the CPU from the same init: its first 10
    losses at rtol 1e-4 and its AUC within 0.01."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import wide_deep_tiny

    rng = np.random.RandomState(0)
    table = rng.randn(64)
    w_dense = rng.randn(4) * 0.5
    ids, xd, y = _ctr_clicks(np, S3_N, rng, table, w_dense, 4, 4)
    ids_t, xd_t, y_t = _ctr_clicks(np, S3_N, np.random.RandomState(7),
                                   table, w_dense, 4, 4)
    out = []
    t0 = time.monotonic()
    for where in (DEVICE, "cpu"):
        ptt.seed(0)
        net = wide_deep_tiny(sparse=True, device=where)
        model = ptt.Model(net, inputs=["sparse", "dense"], labels=["label"])
        model.prepare(optimizer=ptt.optimizer.Adam(1e-2, lazy_mode=True),
                      loss=net.loss)
        losses = [model.train_batch([ids, xd], [y])[0]
                  for _ in range(S3_STEPS)]
        prob = net.predict_proba(model.predict_batch([ids_t, xd_t]))
        prob = prob.reshape(-1).cpu().numpy()
        auc = ptt.metric.Auc()
        auc.update(np.stack([1 - prob, prob], -1), y_t)
        out.append((losses, float(auc.accumulate())))
    (card, auc_card), (cpu, auc_cpu) = out
    np.testing.assert_allclose(card[:10], cpu[:10], rtol=1e-4)
    assert auc_card >= CTR_AUC_GATE, auc_card
    assert abs(auc_card - auc_cpu) < 0.01, (auc_card, auc_cpu)
    log(f"S3 bench.py config 5[{gpu}]: AUC {auc_card:.4f} (gate "
        f"{CTR_AUC_GATE}; CPU {auc_cpu:.4f}), loss {card[0]:.4f} -> "
        f"{card[-1]:.4f} in {S3_STEPS} steps; the first 10 losses at rtol "
        f"1e-4 of the CPU's (largest {max(abs(a - b) / abs(b) for a, b in zip(card[:10], cpu[:10])):.2e}); "
        f"{time.monotonic() - t0:.1f}s")
    return {"auc": auc_card, "auc_cpu": auc_cpu}


def vocab_independence(torch, gpu):
    """Phase S4, ``tools/bench_sparse_embedding.py``'s net (dim 64, batch
    256 x 4 fields, Adam lr 0.01, numpy batches as the tool feeds them) at
    vocab 1e5, 1e6 and 1e7: sparse + lazy, then the dense path (a table
    ``.grad`` and every row's moments) for contrast, each timed over 20
    steps after 3 warm-up ones (synchronized at the end), its peak device
    memory beside it.  Gate (the tool's pass rule): the sparse path's max /
    min step time < 2.0."""
    import numpy as np

    import paddle_tpu_torch as ptt

    Net = _ctr_net_class()
    rows = []
    for sparse in (True, False):
        for vocab in S4_VOCABS:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with torch.device(DEVICE):
                net = Net(vocab, S4_DIM, sparse=sparse)
            gen = torch.Generator(device=DEVICE).manual_seed(SEED)
            for m in net.modules():
                if hasattr(m, "reset_parameters"):
                    m.reset_parameters(gen)
            model = ptt.Model(net, inputs=["ids"], labels=["y"])
            model.prepare(optimizer=ptt.optimizer.Adam(
                0.01, lazy_mode=sparse), loss=_mse)
            rng = np.random.RandomState(0)
            ids = rng.randint(0, vocab, (S4_B, S4_F)).astype(np.int32)
            y = rng.randn(S4_B, 1).astype(np.float32)
            for _ in range(S4_WARMUP):
                model.train_batch([ids], [y])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(S4_ITERS):
                model._train_batch_device([ids], [y])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / S4_ITERS * 1e3
            rows.append({"vocab": vocab, "path": "sparse_lazy" if sparse
                         else "dense", "ms": ms,
                         "peak_bytes": torch.cuda.max_memory_allocated()})
            log(f"S4[{gpu}] " + json.dumps(rows[-1]))
            del net, model
    gc.collect()
    torch.cuda.empty_cache()
    sp = [r["ms"] for r in rows if r["path"] == "sparse_lazy"]
    ratio = max(sp) / min(sp)
    log(f"S4 vocabulary independence[{gpu}]: sparse max/min step time "
        f"{ratio:.3f} (< {S4_RATIO}) over vocab {S4_VOCABS}")
    assert ratio < S4_RATIO, rows
    return {"rows": rows, "ratio": ratio}


# -- k steps per execution as one CUDA graph (steps_per_execution) -----------
# K1's small models (graph k = 4 against k = 1 over 3 executions, 12 steps)
K1_K, K1_EXECUTIONS, K1_B = 4, 3, 32
K1_CTR_VOCAB = 20_000
K1_REL_TOL = 1e-6   # the bound if a cuBLAS product differs under capture
# K2: S2's configuration through fit; K3 / K4: the R and 7 phases' configs
K2_K = 8
K3_K, K3_EXECUTIONS = 4, 3
K4_K, K4_EXECUTIONS = 4, 3
# K5: examples/train_resnet_nhwc.py
K5_N, K5_HW, K5_B, K5_EPOCHS, K5_K = 256, 64, 32, 3, 4


class ExecutionTimer:
    """A ``fit`` callback: the host seconds of each execution (begin to
    the return of the step, nothing waited for) and its wall seconds to
    the card's end (``synchronize`` at the batch end); the losses, read
    after the wait."""

    def __init__(self, torch):
        from paddle_tpu_torch.hapi.callbacks import Callback

        timer = self

        class _Cb(Callback):
            def on_train_batch_begin(self, step, logs=None):
                timer.t0 = time.perf_counter()

            def on_train_batch_end(self, step, logs=None):
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                timer.host.append(t1 - timer.t0)
                timer.wall.append(t2 - timer.t0)
                timer.losses.append(float(logs["loss"]))
                timer.sizes.append(int(logs["batch_size"]))

        self.callback = _Cb()
        self.host, self.wall, self.losses, self.sizes = [], [], [], []
        self.t0 = 0.0


def _state_tensors(opt):
    """An optimizer's state dict as ``{dotted key: tensor}`` (Lookahead's
    nested one flattened) and its count."""
    flat = {}

    def walk(prefix, d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v)
            elif hasattr(v, "dtype"):
                flat[prefix + k] = v
    sd = opt.state_dict()
    walk("", sd)
    return flat, sd.get("count")


def _k1_pair(torch, build, make_opt, loss, spe_graph=K1_K):
    """Two models from one seed: eager (k = 1) and graph (k = 4)."""
    import paddle_tpu_torch as ptt

    out = []
    for spe in (1, spe_graph):
        ptt.seed(SEED)
        net = build()
        m = ptt.Model(net, inputs=1, labels=1)
        m.prepare(optimizer=make_opt(), loss=loss, steps_per_execution=spe)
        out.append((net, m))
    return out


def _k1_compare(torch, tag, eager, graph):
    """Parameters, buffers and optimizer state after the runs: bit-equal,
    else the largest relative difference must be within K1_REL_TOL."""
    (en, em), (gn, gm) = eager, graph
    worst = 0.0
    pairs = list(zip(en.state_dict().items(), gn.state_dict().items()))
    es, ec = _state_tensors(em._optimizer)
    gs, gc_ = _state_tensors(gm._optimizer)
    assert ec == gc_ and es.keys() == gs.keys(), (tag, ec, gc_)
    pairs += [((k, es[k]), (k, gs[k])) for k in es]
    unequal = 0
    for (k, a), (k2, b) in pairs:
        assert k == k2
        if torch.equal(a, b):
            continue
        unequal += 1
        d = ((a.double() - b.double()).abs().max()
             / a.double().abs().max().clamp_min(1e-30)).item()
        worst = max(worst, d)
    log(f"K1[{tag}]: graph vs eager over {len(pairs)} tensors (parameters, "
        f"buffers, optimizer slots; count {gc_}): {unequal} not bit-equal, "
        f"max relative difference {worst:.3e}")
    assert worst <= K1_REL_TOL, (tag, worst)
    return unequal, worst


def graph_vs_eager(torch, gpu):
    """Phase K1: graph (k = 4) against eager (k = 1) on the card over 3
    executions (12 steps) of the same batches, each model built twice
    from one seed: a bf16 MLP with a cross-entropy head under
    ``AdamW(multi_precision=True)`` (kernel 3 in the step); ``WideDeep`` at
    20,000 ids with ``Adam(lazy_mode=True)`` (the sparse branch);
    ``Lookahead(k=5)`` and ``GradientMergeOptimizer(k_steps=3)``; an MLP
    with dropout 0.1.  Gates: parameters, buffers and optimizer state
    bit-equal (else within ``K1_REL_TOL``, printed); the launch counts
    equal after both runs; the dropout masks of one execution all differ
    and a later execution's differ from an earlier one's; the sparse
    step captures (a capture admits no host sync) and replays with CUDA's
    sync check on."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models import WideDeep
    from paddle_tpu_torch.ops import softmax_cross_entropy
    from paddle_tpu_torch.optimizer.gradient_merge import \
        GradientMergeOptimizer

    rng = np.random.RandomState(SEED + 500)
    steps = K1_K * K1_EXECUTIONS

    def mlp(dtype="float32", dropout=0.0, out=1):
        with torch.device(DEVICE):
            layers = [nn.Linear(64, 256), nn.ReLU()]
            if dropout:
                layers.append(nn.Dropout(dropout))
            net = nn.Sequential(*layers, nn.Linear(256, out))
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        for m in net.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
        return net.astype(dtype)

    x = rng.randn(steps, K1_B, 64).astype(np.float32)
    cls = rng.randint(0, 16, (steps, K1_B, 1)).astype(np.int64)
    reg = rng.randn(steps, K1_B, 1).astype(np.float32)

    def run(pair, batches, counter=None):
        """Eager steps, then the graph's executions; the counter's
        launches in each run."""
        (en, em), (gn, gm) = pair
        counts = []
        for m in (em, gm):
            if counter is not None:
                counter.launches = 0
            if m._graph_steps is None:
                for b in batches:
                    m._train_batch_device(list(b[:-1]), [b[-1]])
            else:
                for e in range(K1_EXECUTIONS):
                    m._train_batches_device(
                        batches[e * K1_K:(e + 1) * K1_K])
            torch.cuda.synchronize()
            counts.append(counter.launches if counter is not None else 0)
        g = gm._graph_steps
        assert g.executions == K1_EXECUTIONS and g.captures >= 1, (
            g.executions, g.captures)
        return counts

    out = {}
    # bf16 MLP, AdamW with float32 masters, kernel 3 as the loss
    pair = _k1_pair(
        torch, lambda: mlp("bfloat16", out=16),
        lambda: ptt.optimizer.AdamW(1e-3, multi_precision=True),
        lambda logits, y: softmax_cross_entropy(
            logits.float(), y.squeeze(-1)).mean())
    batches = [(torch.from_numpy(x[i]).to(DEVICE, torch.bfloat16),
                torch.from_numpy(cls[i]).to(DEVICE)) for i in range(steps)]
    counts = run(pair, batches, softmax_cross_entropy)
    log(f"K1[adamw_bf16_mp]: softmax_cross_entropy launches eager "
        f"{counts[0]}, graph {counts[1]} (= {steps}: "
        f"{counts == [steps, steps]})")
    assert counts == [steps, steps], counts
    out["adamw_bf16_mp"] = _k1_compare(torch, "adamw_bf16_mp", *pair)
    # the sparse branch: WideDeep at 20,000 ids, lazy Adam, sync check on
    ids = rng.randint(0, K1_CTR_VOCAB, (steps, K1_B, S2_FIELDS))
    dense = rng.randn(steps, K1_B, S2_DENSE).astype(np.float32)
    click = (rng.uniform(size=(steps, K1_B, 1)) < 0.3).astype(np.float32)
    pair = []
    for spe in (1, K1_K):
        ptt.seed(SEED)
        net = WideDeep(num_fields=S2_FIELDS, vocab_size=K1_CTR_VOCAB,
                       embed_dim=S2_EMBED, dense_dim=S2_DENSE,
                       hidden_sizes=S2_HIDDEN, sparse=True)
        m = ptt.Model(net, inputs=["sparse", "dense"], labels=["label"])
        m.prepare(optimizer=ptt.optimizer.Adam(1e-3, lazy_mode=True),
                  loss=net.loss, steps_per_execution=spe)
        pair.append((net, m))
    sb = [(torch.from_numpy(ids[i]).to(DEVICE),
           torch.from_numpy(dense[i]).to(DEVICE),
           torch.from_numpy(click[i]).to(DEVICE)) for i in range(steps)]
    (en, em), (gn, gm) = pair
    for b in sb:
        em._train_batch_device(list(b[:2]), [b[2]])
    # execution 2 captures (a capture fails on any host sync in the
    # step), execution 3 replays under CUDA's sync check
    gm._train_batches_device(sb[:K1_K])
    gm._train_batches_device(sb[K1_K:2 * K1_K])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gm._train_batches_device(sb[2 * K1_K:])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out["wide_deep_lazy_adam"] = _k1_compare(torch, "wide_deep_lazy_adam",
                                             *pair)
    # the optimizers that branch on the step count
    rb = [(torch.from_numpy(x[i]).to(DEVICE),
           torch.from_numpy(reg[i]).to(DEVICE)) for i in range(steps)]
    for tag, make in (
            ("lookahead_k5", lambda: ptt.optimizer.Lookahead(
                ptt.optimizer.Momentum(0.01, 0.9), alpha=0.5, k=5)),
            ("gradient_merge_k3", lambda: GradientMergeOptimizer(
                ptt.optimizer.Adam(1e-3), k_steps=3))):
        pair = _k1_pair(torch, mlp, make, _mse)
        run(pair, rb)
        log(f"K1[{tag}]: {pair[1][1]._graph_steps.captures} captured "
            f"graphs over {K1_EXECUTIONS} executions")
        out[tag] = _k1_compare(torch, tag, *pair)
    # dropout: the same masks as eager, different ones at every step
    pair = _k1_pair(torch, lambda: mlp(dropout=0.1), lambda:
                    ptt.optimizer.SGD(0.01), _mse)
    (en, em), (gn, gm) = pair
    ptt.seed(SEED + 1)
    el = [em._train_batch_device([b[0]], [b[1]])[0] for b in rb]
    ptt.seed(SEED + 1)
    gl = torch.cat([gm._train_batches_device(rb[e * K1_K:(e + 1) * K1_K])
                    for e in range(K1_EXECUTIONS)])
    assert torch.equal(torch.stack(el), gl), "K1: dropout losses differ"
    out["dropout_0.1"] = _k1_compare(torch, "dropout_0.1", *pair)
    ptt.seed(SEED + 2)
    probe = _k1_pair(torch, lambda: mlp(dropout=0.1),
                     lambda: ptt.optimizer.SGD(0.0), _mse)[1][1]
    same = [rb[0]] * K1_K
    losses = torch.cat([probe._train_batches_device(same)
                        for _ in range(K1_EXECUTIONS)]).tolist()
    distinct = len(set(losses))
    log(f"K1[dropout_0.1]: one batch at lr 0 through {K1_EXECUTIONS} "
        f"executions: {distinct} distinct losses of {len(losses)} (the "
        f"masks of every step differ, within and across replays)")
    assert distinct == len(losses), losses
    return out


def ctr_graph_main_path(torch, gpu, eager):
    """Phase K2, the main path of the k-step slice: S2's configuration
    (``WideDeep`` at 1M ids, ``Adam(1e-3, lazy_mode=True)``) through
    ``Model.fit(steps_per_execution=8)`` on S2's 51,200 rows, loaded by
    ``InMemoryDataset`` as S2 loads them and fed through an
    ``io.TensorDataset`` at batch 256: 200 steps, 25 executions, each
    after the first one CUDA graph replay.  Gates (S2's): losses finite,
    the mean of the last 50 steps below the first 50's, never-drawn rows
    bit-equal to their init, ``predict`` probabilities in (0, 1).  Prints
    the step time (median execution of 3-25, synchronized, over 8),
    samples/s beside S2's eager number, host ms per execution and the
    peak device memory beside S2's."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import WideDeep

    ds, held, n, _ = ctr_dataset(np)
    cols = [np.concatenate(c) for c in zip(*ds.batch_iter(S2_B))]
    ptt.seed(SEED)
    net = WideDeep(num_fields=S2_FIELDS, vocab_size=CTR_VOCAB,
                   embed_dim=S2_EMBED, dense_dim=S2_DENSE,
                   hidden_sizes=S2_HIDDEN, sparse=True)
    model = ptt.Model(net, inputs=["sparse", "dense"], labels=["label"])
    model.prepare(optimizer=ptt.optimizer.Adam(1e-3, lazy_mode=True),
                  loss=net.loss, steps_per_execution=K2_K)
    w0 = {k: getattr(net, k).weight.detach().clone()
          for k in ("embedding", "wide")}
    timer = ExecutionTimer(torch)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    model.fit(ptt.io.TensorDataset(cols), batch_size=S2_B, epochs=1,
              shuffle=False, verbose=0, callbacks=[timer.callback])
    peak = torch.cuda.max_memory_allocated()
    ex = len(timer.wall)
    assert ex == S2_ROWS // S2_B // K2_K, ex
    assert set(timer.sizes) == {S2_B * K2_K}, timer.sizes
    g = model._graph_steps
    assert g.executions == ex and g.captures == 1, (g.executions,
                                                    g.captures)
    losses = timer.losses  # per execution: the mean of its 8 steps
    assert all(math.isfinite(v) for v in losses), losses
    k50 = 50 // K2_K + 1   # the executions holding the first / last 50
    first, last = np.mean(losses[:k50]), np.mean(losses[-k50:])
    assert last < first, (first, last)
    seen = torch.zeros(CTR_VOCAB, dtype=torch.bool, device=DEVICE)
    seen[torch.from_numpy(np.unique(cols[0])).to(DEVICE)] = True
    for k, w in w0.items():
        now = getattr(net, k).weight.detach()
        assert torch.equal(now[~seen], w[~seen]), f"K2: {k} rows moved"
        assert not torch.equal(now[seen], w[seen]), f"K2: {k} untrained"
    prob = net.predict_proba(torch.from_numpy(np.concatenate(
        model.predict(ptt.io.TensorDataset([held[0], held[1]]),
                      batch_size=S2_HELDOUT))))
    assert prob.shape == (S2_HELDOUT, 1)
    assert bool(((prob > 0) & (prob < 1)).all()), "K2: probabilities"
    med = float(np.median(timer.wall[2:])) / K2_K
    host = float(np.median(timer.host[2:]))
    out = {"k": K2_K, "executions": ex, "step_ms": med * 1e3,
           "samples_per_s": S2_B / med, "host_ms_per_execution": host * 1e3,
           "first_execution_ms": timer.wall[0] * 1e3,
           "capture_execution_ms": timer.wall[1] * 1e3,
           "peak_bytes": peak, "eager_step_ms": eager["step_ms"],
           "eager_samples_per_s": eager["samples_per_s"],
           "eager_peak_bytes": eager["peak_bytes"],
           "first": float(first), "last": float(last)}
    log(f"K2 sparse CTR through fit(steps_per_execution={K2_K})[{gpu}]: "
        f"{ex} executions of {K2_K} steps, 1 graph; step {med * 1e3:.3f} ms "
        f"(median of executions 3-{ex} / {K2_K}), {S2_B / med:.0f} samples/s "
        f"(S2 eager: {eager['step_ms']:.3f} ms, "
        f"{eager['samples_per_s']:.0f} samples/s); host "
        f"{host * 1e3:.3f} ms per execution; execution 1 (eager) "
        f"{timer.wall[0] * 1e3:.1f} ms, 2 (capture + replay) "
        f"{timer.wall[1] * 1e3:.1f} ms; loss first {first:.4f} -> last "
        f"{last:.4f}; never-drawn rows bit-equal; peak device memory "
        f"{peak / 2 ** 20:.0f} MiB (S2 eager "
        f"{eager['peak_bytes'] / 2 ** 20:.0f} MiB)")
    del net, model, w0, seen
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _counts_per_execution(counters):
    """A callback zeroing ``counters`` at each execution's begin and
    recording their values at its end."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    seen = []

    class _Cb(Callback):
        def on_train_batch_begin(self, step, logs=None):
            for obj, attr in counters:
                setattr(obj, attr, 0)

        def on_train_batch_end(self, step, logs=None):
            seen.append(tuple(getattr(obj, a) for obj, a in counters))

    return _Cb(), seen


def resnet_graph(torch, gpu, eager):
    """Phase K3: bench.py's config 2 (phase R3's model and optimizer)
    through ``Model.fit(steps_per_execution=4)`` over 4 seeded batches of
    128 x 224 x 224 on the card, 3 executions (12 steps): kernels 7 and 8
    inside the graph.  Gates: losses finite; every bn3 buffer moved; the
    launches of each execution (counted per replay) = 16 a step each, as
    R3's eager steps.  Prints the replayed execution's step time beside
    R3's eager step, and the peak device memory beside R3's."""
    import numpy as np

    from paddle_tpu_torch.ops import bn_apply_relu, conv1x1_bn_stats

    net = resnet_model(torch, "bfloat16", DEVICE,
                       torch.Generator().manual_seed(SEED))
    model = resnet_trainer(torch, net)
    model.prepare(optimizer=model._optimizer, loss=model._loss,
                  steps_per_execution=K3_K)
    rng = np.random.RandomState(SEED + 600)
    data = [(torch.from_numpy(rng.uniform(
        -1, 1, (RESNET_B, RESNET_HW, RESNET_HW, 3)).astype(np.float32)).to(
        DEVICE, torch.bfloat16), torch.from_numpy(rng.randint(
            0, 1000, (RESNET_B, 1)).astype(np.int32)).to(DEVICE))
        for _ in range(K3_K)]
    bn3 = {n: b.clone() for n, b in net.named_buffers() if ".bn3." in n}
    timer = ExecutionTimer(torch)
    counts_cb, counts = _counts_per_execution(
        [(conv1x1_bn_stats, "launches"), (bn_apply_relu, "launches")])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model.fit(data * K3_EXECUTIONS, epochs=1, verbose=0,
              callbacks=[counts_cb, timer.callback])
    peak = torch.cuda.max_memory_allocated()
    want = RESNET_BLOCKS * K3_K
    log(f"K3[resnet50]: execution losses {timer.losses}; launches per "
        f"execution (conv1x1_bn_stats, bn_apply_relu) {counts} (= {want} "
        f"each: 16 a step x {K3_K})")
    assert len(counts) == K3_EXECUTIONS
    assert all(c == (want, want) for c in counts), counts
    assert all(math.isfinite(v) for v in timer.losses), timer.losses
    for n, b in net.named_buffers():
        if n in bn3:
            assert not torch.equal(b, bn3[n]), f"K3: {n} did not change"
    step = timer.wall[-1] / K3_K
    out = {"k": K3_K, "step_ms": step * 1e3,
           "host_ms_per_execution": timer.host[-1] * 1e3,
           "eager_step_ms": eager["step_ms"], "peak_bytes": peak,
           "eager_peak_bytes": eager["peak_bytes"],
           "graph_launches": {"conv1x1_bn_stats": counts[-1][0],
                              "bn_apply_relu": counts[-1][1]}}
    log(f"K3 ResNet-50 through fit(steps_per_execution={K3_K})[{gpu}]: "
        f"replayed execution {timer.wall[-1] * 1e3:.2f} ms = "
        f"{step * 1e3:.2f} ms/step (R3 eager {eager['step_ms']:.2f} "
        f"ms/step), host {timer.host[-1] * 1e3:.2f} ms per execution; "
        f"every bn3 buffer moved; peak device memory "
        f"{peak / 2 ** 20:.0f} MiB (R3 eager "
        f"{eager['peak_bytes'] / 2 ** 20:.0f} MiB)")
    del model, net, data
    gc.collect()
    torch.cuda.empty_cache()
    return out


def bert_graph(torch, gpu, eager):
    """Phase K4: phase 7's BERT-base bf16 pretraining (dropout 0.1,
    ``AdamW(multi_precision=True)``) through
    ``Model.fit(steps_per_execution=4)`` over 4 seeded batches, 3
    executions: kernels 2 (24 forward and 24 backward launches a step) and
    3 (1 a step) inside the graph with the registered dropout generator.
    Gates: losses finite, the counts of each execution.  Prints the
    replayed execution's step time beside phase 7's."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import BertForPretraining, bert_base
    from paddle_tpu_torch.ops import layernorm_residual, softmax_cross_entropy

    cfg = bert_base()
    ptt.seed(SEED)
    net = BertForPretraining(cfg, device=DEVICE).astype("bfloat16")
    opt = ptt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                              multi_precision=True)
    model = ptt.Model(net, ["input_ids", "token_type_ids", "attention_mask",
                            "masked_positions"],
                      ["mlm_labels", "nsp_labels"]).prepare(
        optimizer=opt, loss=net.loss, steps_per_execution=K4_K)
    data = []
    for i in range(K4_K):
        inputs, labels = bert_batch(cfg.vocab_size, BERT_B, BERT_S, BERT_P,
                                    seed=SEED + 700 + i)
        data.append(tuple(torch.from_numpy(a).to(DEVICE)
                          for a in inputs + labels))
    timer = ExecutionTimer(torch)
    counters = [(layernorm_residual, "launches"),
                (layernorm_residual, "backward_launches"),
                (softmax_cross_entropy, "launches")]
    counts_cb, counts = _counts_per_execution(counters)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model.fit(data * K4_EXECUTIONS, epochs=1, verbose=0,
              callbacks=[counts_cb, timer.callback])
    peak = torch.cuda.max_memory_allocated()
    want = (2 * cfg.num_layers * K4_K, 2 * cfg.num_layers * K4_K, K4_K)
    log(f"K4[bert]: execution losses {timer.losses}; launches per "
        f"execution (layernorm_residual, its backward, "
        f"softmax_cross_entropy) {counts} (= {want})")
    assert all(c == want for c in counts), counts
    assert all(math.isfinite(v) for v in timer.losses), timer.losses
    step = timer.wall[-1] / K4_K
    out = {"k": K4_K, "step_ms": step * 1e3,
           "host_ms_per_execution": timer.host[-1] * 1e3,
           "eager_step_ms": eager["step_ms"], "peak_bytes": peak,
           "eager_peak_bytes": eager["peak_bytes"],
           "graph_launches": {"layernorm_residual": counts[-1][0],
                              "layernorm_residual_backward": counts[-1][1],
                              "softmax_cross_entropy": counts[-1][2]}}
    log(f"K4 BERT-base bf16 through fit(steps_per_execution={K4_K})[{gpu}]:"
        f" replayed execution {timer.wall[-1] * 1e3:.2f} ms = "
        f"{step * 1e3:.2f} ms/step (phase 7 eager {eager['step_ms']:.2f} "
        f"ms/step), host {timer.host[-1] * 1e3:.2f} ms per execution; peak "
        f"device memory {peak / 2 ** 20:.0f} MiB (phase 7 eager "
        f"{eager['peak_bytes'] / 2 ** 20:.0f} MiB)")
    del model, net, opt, data
    gc.collect()
    torch.cuda.empty_cache()
    return out


def resnet18_example(torch, gpu):
    """Phase K5: ``examples/train_resnet_nhwc.py`` line for line in the
    port: ``resnet18(num_classes=10, data_format="NHWC")`` in bf16,
    ``Momentum(0.05, 0.9, multi_precision=True, weight_decay=1e-4)``,
    ``steps_per_execution=4``, a ``TensorDataset`` of 256 x 64 x 64 x 3,
    batch 32, 3 epochs (no hand kernel on this path: BasicBlocks have no
    1x1 tail).  Gates: losses finite; callbacks fired once per execution
    (2 an epoch)."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.vision.models import resnet18

    paddle.seed(0)
    net = resnet18(num_classes=10, data_format="NHWC").astype("bfloat16")
    opt = popt.Momentum(learning_rate=0.05, momentum=0.9,
                        multi_precision=True, weight_decay=1e-4)
    model = paddle.Model(net, inputs=["image"], labels=["label"])
    model.prepare(optimizer=opt, loss=nn.CrossEntropyLoss(),
                  steps_per_execution=K5_K)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (K5_N, K5_HW, K5_HW, 3)).astype(np.float32)
    y = rng.randint(0, 10, (K5_N, 1)).astype(np.int64)
    timer = ExecutionTimer(torch)
    t0 = time.perf_counter()
    model.fit(paddle.io.TensorDataset([x, y]), batch_size=K5_B,
              epochs=K5_EPOCHS, verbose=0, callbacks=[timer.callback])
    wall = time.perf_counter() - t0
    per_epoch = K5_N // K5_B // K5_K
    assert len(timer.wall) == per_epoch * K5_EPOCHS, len(timer.wall)
    assert set(timer.sizes) == {K5_B * K5_K}, timer.sizes
    assert all(math.isfinite(v) for v in timer.losses), timer.losses
    log(f"K5 examples/train_resnet_nhwc.py in the port[{gpu}]: "
        f"{len(timer.wall)} executions ({per_epoch} an epoch, callbacks "
        f"once each), execution losses {[round(v, 4) for v in timer.losses]}"
        f", {wall:.2f}s")
    return {"executions": len(timer.wall), "losses": timer.losses}


def tensor_api_card(torch, gpu):
    """Phase T1: the tensor API on the card.  Every exported name of
    ``paddle_tpu_torch.tensor`` (``tools/torch_tensor_cases.py``'s one
    call each) run on CUDA inputs against the same call on CPU inputs, at
    ``CARD_TOL`` by class (exact; float32 elementwise rtol / atol 1e-5;
    special functions 1e-4 / 1e-5; factorizations 1e-3 / 1e-4 in
    sign-free forms); every tensor result on ``cuda:0``; creation
    functions called without a device land on ``cuda:0``; the random
    functions' shapes and dtypes equal the CPU's, their draws on the card
    and within their moments."""
    import importlib.util

    import numpy as np

    import paddle_tpu_torch.tensor as tt
    from paddle_tpu_torch.framework import device as dv
    from paddle_tpu_torch.framework.dtype import numpy_to_tensor, to_numpy

    spec = importlib.util.spec_from_file_location(
        "torch_tensor_cases", os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tools",
            "torch_tensor_cases.py"))
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    card = torch.device("cuda", 0)

    def run(name, make, device):
        dv._chosen = torch.device("cpu") if device == "cpu" else None
        try:
            args, kwargs = make(np.random.RandomState(0))

            def to(a):
                return numpy_to_tensor(a, device)
            out = getattr(tt, name)(*cases.convert(args, to),
                                    **cases.convert(kwargs, to))
        finally:
            dv._chosen = None
        leaves = out if isinstance(out, (list, tuple)) else [out]
        return [x for x in leaves if isinstance(x, torch.Tensor)], \
            cases.to_host(out, to_numpy)

    failed, n = [], 0
    for name, (make, kind) in sorted(cases.CASES.items()):
        n += 1
        try:
            tensors, got = run(name, make, "cuda")
            assert all(x.device == card for x in tensors), name
            _, want = run(name, make, "cpu")
            cases.compare(kind, got, want, cases.CARD_TOL)
        except Exception as e:  # noqa: BLE001 — collected, raised below
            failed.append(f"{name}: {type(e).__name__}: {str(e)[:200]}")
    for name, make in sorted(cases.RANDOM.items()):
        n += 1
        try:
            tensors, got = run(name, make, "cuda")
            assert all(x.device == card for x in tensors), name
            _, want = run(name, make, "cpu")
            got, want = np.asarray(got), np.asarray(want)
            assert got.shape == want.shape and got.dtype == want.dtype, (
                got.shape, want.shape, got.dtype, want.dtype)
            mean, std = cases.MOMENTS[name]
            spread = std if std is not None else float(np.std(got)) or 1.0
            assert abs(float(got.mean()) - mean) < 5 * spread / np.sqrt(
                got.size), (float(got.mean()), mean)
        except Exception as e:  # noqa: BLE001
            failed.append(f"{name}: {type(e).__name__}: {str(e)[:200]}")
    made = [getattr(tt, f)([2, 3]) for f in ("zeros", "ones", "empty",
                                            "rand", "randn")] + [
        tt.full([2], 1.0), tt.arange(4), tt.eye(2), tt.linspace(0, 1, 3),
        tt.to_tensor([1.0, 2.0])]
    assert all(x.device == card for x in made), [x.device for x in made]
    log(f"T1 tensor API[{gpu}]: {n} calls on the card against the CPU, "
        f"{n - len(failed)} agree; creation without a device lands on "
        f"{card}")
    for line in failed:
        log(f"T1 FAILED {line}")
    assert not failed, failed
    return {"calls": n, "failed": len(failed)}


# -- the 1.x static graph: bench.py's configs 1-3 through their entry point --
# bench.py's constants (its configs' shapes and chain lengths, the accuracy
# gate and the work per item its achieved_tflops divides by)
MNIST_ACC_GATE = 0.97
BERT_TRAIN_GFLOP_PER_SEQ = 84.5
RESNET50_TRAIN_GFLOP_PER_IMG = 12.3
H100_BF16_TFLOPS = 989.0       # H100 SXM dense bf16 (data sheet), 700 W
ST_BERT_STEPS, ST_RESNET_STEPS, ST_WINDOWS = 10, 60, 2


def _st_counts(counters):
    return {f"{obj.__name__}{'' if a == 'launches' else '_backward'}":
            getattr(obj, a) for obj, a in counters}


def _st_zero(counters):
    for obj, attr in counters:
        setattr(obj, attr, 0)


def _st_runner(exe):
    """The GraphSteps of the Executor's most recent run_steps signature."""
    return next(reversed(exe._cache._entries.values()))


def st_windows(torch, exe, window, counters, label):
    """bench.py's timing: a warm window (the first call of the signature
    runs its steps eagerly), then — the port's second warm-up — the
    window that captures the CUDA graph and replays it, then ST_WINDOWS
    timed windows, each one replay; the counts zeroed just before each
    timed window and read just after.  Returns the windows' seconds, final
    losses and counts."""
    out = {"final": [], "seconds": [], "counts": []}
    for tag in ("eager", "capture"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = window()
        out[f"{tag}_s"] = time.perf_counter() - t0
        out[f"{tag}_final"] = final
        assert math.isfinite(final), (label, tag, final)
    for _ in range(ST_WINDOWS):
        torch.cuda.synchronize()
        _st_zero(counters)
        d0 = exe.dispatches
        t0 = time.perf_counter()
        final = window()  # the fetch's host copy waits for the card
        out["seconds"].append(time.perf_counter() - t0)
        out["counts"].append(_st_counts(counters))
        assert exe.dispatches == d0 + 1, (label, exe.dispatches, d0)
        assert math.isfinite(final), (label, final)
        out["final"].append(final)
    g = _st_runner(exe)
    assert g.captures == 1 and g.executions == 2 + ST_WINDOWS, (
        label, g.captures, g.executions)
    return out


def _st_summary(per_window_s, items, gflop):
    s = sorted(per_window_s)
    med = s[len(s) // 2]
    rate = items / med
    return {"median": rate, "min": items / s[-1], "max": items / s[0],
            "best": items / s[0], "window_s": per_window_s,
            "achieved_tflops": rate * gflop / 1e3,
            "mfu_vs_h100_dense_bf16_989": rate * gflop / 1e3
            / H100_BF16_TFLOPS}


def st_mnist(torch, gpu):
    """Phase ST1: bench.py config 1 (``bench_mnist``) exactly, with the
    port's API on the card: 150 SGD steps in one ``run_steps`` over 4096
    synthetic rows, then ``clone(for_test=True)`` on 2048; accuracy >=
    ``MNIST_ACC_GATE``, one dispatch for the chain."""
    import numpy as np

    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import nn
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.static.builders import layer_op
    from paddle_tpu_torch.static.graph import record_call

    paddle.seed(0)
    rng = np.random.RandomState(0)
    protos = rng.uniform(0, 1, (10, 784)).astype(np.float32)

    def batch(n, seed):
        r = np.random.RandomState(seed)
        y = r.randint(0, 10, n).astype(np.int32)
        x = protos[y] + r.normal(0, 0.35, (n, 784)).astype(np.float32)
        return (x - 0.5).astype(np.float32), y

    net = nn.Sequential(nn.Linear(784, 128), nn.ReLU(),
                        nn.Linear(128, 64), nn.ReLU(), nn.Linear(64, 10))

    def nll(logits, y):
        lp = torch.log_softmax(logits, -1)
        return -torch.take_along_dim(lp, y[:, None].long(), 1).mean()

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, 784])
        y = fluid.data("y", [-1], "int32")
        logits = layer_op(net, x, prefix="mlp")
        loss = record_call(nll, logits, y, prefix="nll")
        popt.SGD(learning_rate=0.05).minimize(loss)

    xs, ys = batch(4096, 1)
    exe = fluid.Executor()
    exe.run(startup)
    d0 = exe.dispatches
    t0 = time.perf_counter()
    out, = exe.run_steps(main, feed={"x": xs, "y": ys}, fetch_list=[loss],
                         iterations=150, fetch_every=150,
                         constant_feeds=("x", "y"))
    chain_s = time.perf_counter() - t0
    assert exe.dispatches == d0 + 1, (exe.dispatches, d0)
    xt, yt = batch(2048, 2)
    test_prog = main.clone(for_test=True)
    pred, = exe.run(test_prog, feed={"x": xt, "y": yt}, fetch_list=[logits])
    acc = float((np.asarray(pred).argmax(-1) == yt).mean())
    assert all(t.device.type == "cuda" for t in main.scope.values())
    log(f"ST1 bench_mnist[{gpu}]: 150 SGD steps in one run_steps (the "
        f"signature's first call: eager) {chain_s:.3f} s, last loss "
        f"{float(out[-1]):.4f}; test clone accuracy {acc:.4f} (gate "
        f"{MNIST_ACC_GATE}: {acc >= MNIST_ACC_GATE})")
    assert acc >= MNIST_ACC_GATE, acc
    return {"mnist_mlp_smoke_accuracy": acc, "chain_s": chain_s,
            "final_loss": float(out[-1])}


def st_example(torch, gpu):
    """Phase ST2: ``examples/static_graph_1x.py``'s flow on
    ``Executor(CUDAPlace(0))``: conv2d → pool2d → batch_norm →
    fc(softmax) → cross_entropy with ``AdamOptimizer(0.01)``, 60
    ``exe.run`` steps on its seeded data.  Gates: the loss falls (the
    last ten under half the first ten), the BatchNorm statistics move, a
    test clone leaves them as they are."""
    import numpy as np

    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.fluid as fluid

    paddle.seed(0)
    main_prog, startup_prog = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup_prog):
        img = fluid.data("img", [-1, 1, 28, 28])
        label = fluid.data("label", [-1, 1], dtype="int64")
        conv = fluid.layers.conv2d(img, num_filters=8, filter_size=5,
                                   act="relu")
        pool = fluid.layers.pool2d(conv, pool_size=2, pool_stride=2)
        bn = fluid.layers.batch_norm(pool)
        pred = fluid.layers.fc(bn, size=10, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.optimizer.AdamOptimizer(learning_rate=0.01).minimize(loss)

    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup_prog)
    bufs0 = {k: v.clone() for k, v in main_prog.buffers.items()}
    rng = np.random.RandomState(0)
    protos = rng.rand(10, 1, 28, 28).astype(np.float32)
    losses = []
    t0 = time.perf_counter()
    for step in range(60):
        y = rng.randint(0, 10, 64)
        x = protos[y] + 0.1 * rng.randn(64, 1, 28, 28).astype(np.float32)
        loss_v, = exe.run(main_prog,
                          feed={"img": x,
                                "label": y[:, None].astype(np.int64)},
                          fetch_list=[loss])
        losses.append(float(loss_v))
    wall = time.perf_counter() - t0
    assert all(t.device.type == "cuda" for t in main_prog.scope.values())
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    moved = [k for k, v in bufs0.items()
             if not torch.equal(v, main_prog.buffers[k])]
    clone = main_prog.clone(for_test=True)
    before = {k: v.clone() for k, v in main_prog.buffers.items()}
    exe.run(clone, feed={"img": x, "label": y[:, None].astype(np.int64)},
            fetch_list=[pred])
    frozen = all(torch.equal(v, main_prog.buffers[k])
                 for k, v in before.items())
    log(f"ST2 static_graph_1x[{gpu}]: 60 exe.run steps in {wall:.2f} s "
        f"({wall / 60 * 1e3:.2f} ms a step), mean loss of the first / last "
        f"ten {first:.4f} / {last:.4f}; BatchNorm buffers moved: "
        f"{len(moved)} of {len(bufs0)}; a test clone left them: {frozen}")
    assert last < 0.5 * first, (first, last)
    assert len(moved) == len(bufs0), moved
    assert frozen
    return {"first_losses": first, "last_losses": last,
            "step_ms": wall / 60 * 1e3}


def _st_bert_program(torch, cfg, BATCH, SEQ, MAX_PRED):
    """bench.py config 3's program (``bench_bert``, bench.py:151-222) with
    the port's API, line for line."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.models import BertForPretraining
    from paddle_tpu_torch.static.builders import layer_op
    from paddle_tpu_torch.static.graph import record_call

    net = BertForPretraining(cfg).astype("bfloat16")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids_v = fluid.data("input_ids", [BATCH, SEQ], "int32")
        tt_v = fluid.data("token_type_ids", [BATCH, SEQ], "int32")
        am_v = fluid.data("attention_mask", [BATCH, SEQ], "int32")
        mp_v = fluid.data("masked_positions", [BATCH, MAX_PRED], "int32")
        mlm_y = fluid.data("mlm_labels", [BATCH, MAX_PRED], "int32")
        nsp_y = fluid.data("nsp_labels", [BATCH, 1], "int32")
        mlm_logits, nsp_logits = layer_op(
            net, ids_v, prefix="bert", extra_args=(tt_v, am_v, mp_v))
        loss = record_call(net.loss, mlm_logits, nsp_logits, mlm_y, nsp_y,
                           prefix="bert_loss")
        popt.AdamW(learning_rate=1e-4, weight_decay=0.01,
                   multi_precision=True).minimize(loss)
    return net, main, startup, loss


def _st_bert_feeds(cfg, BATCH, SEQ, MAX_PRED):
    import numpy as np

    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, size=(BATCH, SEQ)).astype(np.int32)
    positions = np.stack([
        np.sort(rng.choice(SEQ, MAX_PRED, replace=False))
        for _ in range(BATCH)]).astype(np.int32)
    return {
        "input_ids": ids,
        "token_type_ids": (rng.uniform(size=(BATCH, SEQ)) < 0.5)
        .astype(np.int32),
        "attention_mask": np.ones((BATCH, SEQ), np.int32),
        "masked_positions": positions,
        "mlm_labels": np.take_along_axis(ids, positions, axis=1),
        "nsp_labels": rng.randint(0, 2, size=(BATCH, 1)).astype(np.int32),
    }


def st_bert(torch, gpu, eager, k4):
    """Phase ST3: bench.py config 3 exactly — BERT-base bf16 at 256 x 128,
    20 masked positions, AdamW(multi_precision) — through
    ``Executor.run_steps(iterations=10, fetch_every=10,
    constant_feeds=all)`` on the card: the warm window (eager), the
    capture window, 3 timed windows, each one graph replay.  Gates: kernel
    2's forward / backward and kernel 3's counts of each timed window 24 /
    24 / 1 x 10; final losses finite and falling; float32 masters.  Then,
    with dropout 0 (``bert_base(dropout=0.0)``) and deterministic
    algorithms, a replayed window against 10 ``exe.run`` steps from the
    same state: parameters, the last loss and every optimizer-state tensor
    bit-equal, and a second eager run bit-equal to the first."""
    import numpy as np

    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import bert_base
    from paddle_tpu_torch.ops import layernorm_residual, softmax_cross_entropy
    from paddle_tpu_torch.static.graph import _copy_into

    BATCH, SEQ, MAX_PRED, N_STEPS = BERT_B, BERT_S, BERT_P, ST_BERT_STEPS
    counters = [(layernorm_residual, "launches"),
                (layernorm_residual, "backward_launches"),
                (softmax_cross_entropy, "launches")]
    paddle.seed(0)
    cfg = bert_base()
    t0 = time.perf_counter()
    net, main, startup, loss = _st_bert_program(torch, cfg, BATCH, SEQ,
                                                MAX_PRED)
    build_s = time.perf_counter() - t0
    feeds = _st_bert_feeds(cfg, BATCH, SEQ, MAX_PRED)
    exe = fluid.Executor()
    exe.run(startup)

    def window():
        out, = exe.run_steps(main, feed=feeds, fetch_list=[loss],
                             iterations=N_STEPS, fetch_every=N_STEPS,
                             constant_feeds=tuple(feeds))
        return float(np.asarray(out)[-1])

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    w = st_windows(torch, exe, window, counters, "ST3")
    peak = torch.cuda.max_memory_allocated()
    want = {"layernorm_residual": 2 * cfg.num_layers * N_STEPS,
            "layernorm_residual_backward": 2 * cfg.num_layers * N_STEPS,
            "softmax_cross_entropy": N_STEPS}
    assert all(c == want for c in w["counts"]), w["counts"]
    finals = [w["eager_final"], w["capture_final"]] + w["final"]
    assert finals[-1] < finals[0], finals
    slots = main._opt_state["slots"]
    assert all(s["master"].dtype == torch.float32 for s in slots.values())
    rate = _st_summary(w["seconds"], BATCH * N_STEPS,
                       BERT_TRAIN_GFLOP_PER_SEQ)
    step_ms = sorted(w["seconds"])[1] / N_STEPS * 1e3
    log(f"ST3 bench_bert[{gpu}]: program built in {build_s:.1f} s (shapes "
        f"on the meta device); windows of {N_STEPS} steps: eager "
        f"{w['eager_s']:.3f} s, capture + replay {w['capture_s']:.3f} s, "
        f"timed {[round(s, 4) for s in w['seconds']]} s; final losses "
        f"{[round(v, 4) for v in finals]}; launches per timed window "
        f"{w['counts'][0]} (= {want}); peak device memory "
        f"{peak / 2**20:.0f} MiB")
    log(f"ST3 bert_base_train_seq_per_sec_per_chip[{gpu}]: median "
        f"{rate['median']:.2f} (range {rate['min']:.2f}-{rate['max']:.2f}, "
        f"bench.py's best-window {rate['best']:.2f}) seq/s = {step_ms:.2f} "
        f"ms a step; achieved {rate['achieved_tflops']:.1f} TFLOP/s at "
        f"84.5 GFLOP/seq ({rate['mfu_vs_h100_dense_bf16_989']:.3f} of the "
        f"H100's dense bf16 989 TFLOP/s); beside Model.train_batch "
        f"(phase 7) {eager['step_ms']:.2f} ms a step and "
        f"fit(steps_per_execution=4) (K4) {k4['step_ms']:.2f}")
    out = {"rate": rate, "step_ms": step_ms,
           "train_batch_step_ms": eager["step_ms"],
           "k4_step_ms": k4["step_ms"], "windows": w, "peak_bytes": peak,
           "launches": w["counts"][-1]}
    del exe, main, startup, net, loss
    gc.collect()
    torch.cuda.empty_cache()

    # dropout 0: a replayed window against 10 exe.run steps, bit for bit.
    # Deterministic algorithms on both sides, from the eager window on:
    # without them torch's embedding backward sums a table of few rows
    # (the 2 token types, the 128 positions) in an order that changes from
    # run to run, and the token types' Adam moments differ in their last
    # bits between two eager runs as often as between a replay and eager.
    with _deterministic_algorithms(torch):
        paddle.seed(0)
        cfg0 = bert_base(dropout=0.0)
        net, main, startup, loss = _st_bert_program(torch, cfg0, BATCH, SEQ,
                                                    MAX_PRED)
        exe = fluid.Executor()
        exe.run(startup)
        window()
        window()  # eager, then the capture: the next call is a replay

        def snapshot():
            return ({n: t.detach().clone() for n, t in main.scope.items()},
                    _clone_state(main._opt_state))

        scope0, state0 = snapshot()
        replay_final = window()
        scope1, state1 = snapshot()

        def eager_from_start():
            with torch.no_grad():
                for n, t in main.scope.items():
                    t.copy_(scope0[n])
            _copy_into(main._opt_state, _clone_state(state0))
            losses = [float(exe.run(main, feed=feeds, fetch_list=[loss])[0])
                      for _ in range(N_STEPS)]
            return losses, snapshot()

        eager_losses, (scope2, state2) = eager_from_start()
        again_losses, (scope3, state3) = eager_from_start()
    diff_params = _tree_diff(scope1, scope2)
    diff_replay = _tree_diff(state1, state2)
    diff_eager = _tree_diff(state3, state2)
    diff_eager.update(_tree_diff(scope3, scope2))
    log(f"ST3 dropout 0, deterministic algorithms: a replayed window against "
        f"{N_STEPS} exe.run steps from the same state: last loss "
        f"{replay_final!r} / {eager_losses[-1]!r} (a second eager run "
        f"{again_losses[-1]!r}); tensors differing replay vs eager: "
        f"parameters {len(diff_params)}, optimizer state {len(diff_replay)}; "
        f"eager vs eager {len(diff_eager)}: "
        f"{sorted({**diff_params, **diff_replay, **diff_eager})[:6]}")
    assert not diff_params, ("ST3: replayed parameters differ from eager "
                             "ones", sorted(diff_params.items())[:6])
    assert replay_final == eager_losses[-1], (replay_final, eager_losses)
    assert not diff_replay, ("ST3: replayed optimizer state differs from "
                             "eager", sorted(diff_replay.items())[:6])
    assert not diff_eager and again_losses == eager_losses, (
        "ST3: two eager runs differ under deterministic algorithms",
        sorted(diff_eager.items())[:6])
    out["bit_equal"] = {"parameters": True, "last_loss": True,
                        "optimizer_state": True,
                        "deterministic_algorithms": True}
    del exe, main, startup, net, scope0, scope1, scope2, scope3
    del state0, state1, state2, state3
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _deterministic_algorithms(torch):
    """``torch.use_deterministic_algorithms(True)`` for the block (an op
    with no deterministic implementation raises), then as it was."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _clone_state(tree):
    if isinstance(tree, dict):
        return {k: _clone_state(v) for k, v in tree.items()}
    return tree.clone() if hasattr(tree, "clone") else tree


def _tree_diff(a, b, prefix=""):
    """``{path: max |a - b|}`` of the tensors (and other leaves, as inf) in
    which two state trees of one layout differ."""
    out = {}
    if isinstance(a, dict):
        for k in a:
            out.update(_tree_diff(a[k], b[k], f"{prefix}{k}."))
    elif hasattr(a, "dtype") and hasattr(a, "shape"):
        import torch

        if not torch.equal(a, b):
            out[prefix[:-1]] = float((a.float() - b.float()).abs().max())
    elif a != b:
        out[prefix[:-1]] = float("inf")
    return out


def _st_resnet_program(torch, BATCH):
    """bench.py config 2's program (``bench_resnet50``, bench.py:225-290)
    with the port's API, line for line, and its feeds (bench.py's
    ml_dtypes bf16 image: the same values, rounded to nearest even, as a
    bf16 tensor)."""
    import numpy as np

    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.static.builders import layer_op
    from paddle_tpu_torch.static.graph import record_call
    from paddle_tpu_torch.vision.models import resnet50

    net = resnet50(data_format="NHWC",
                   stem_space_to_depth=True).astype("bfloat16")
    loss_layer = paddle.nn.CrossEntropyLoss()

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.data("image", [BATCH, 224, 224, 3], "bfloat16")
        label = fluid.data("label", [BATCH, 1], "int32")
        logits = layer_op(net, img, prefix="resnet50")
        loss = record_call(
            lambda o, y: loss_layer(o.to(torch.float32), y),
            logits, label, prefix="xent")
        popt.Momentum(learning_rate=0.1, momentum=0.9, multi_precision=True,
                      weight_decay=1e-4).minimize(loss)

    rng = np.random.RandomState(0)
    feeds = {"image": torch.from_numpy(rng.uniform(
        -1, 1, (BATCH, 224, 224, 3)).astype(np.float32)).to(torch.bfloat16),
        "label": rng.randint(0, 1000, (BATCH, 1)).astype(np.int32)}
    return net, main, startup, loss, feeds


def st_resnet(torch, gpu, eager, k3):
    """Phase ST4: bench.py config 2 exactly — ResNet-50 NHWC with the
    space-to-depth stem in bf16 at 128 x 224 x 224, the loss on
    ``logits.float()``, Momentum(0.1, 0.9, multi_precision, weight_decay
    1e-4) — through ``run_steps(iterations=60, fetch_every=60,
    constant_feeds=("image", "label"))``: the warm window, the capture
    window, 3 timed windows of one replay each.  Gates: kernels 7 and 8
    16 x 60 launches each a timed window, final losses finite, every
    BatchNorm buffer moved."""
    import numpy as np

    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.ops import bn_apply_relu, conv1x1_bn_stats

    BATCH, N_STEPS = RESNET_B, ST_RESNET_STEPS
    counters = [(conv1x1_bn_stats, "launches"), (bn_apply_relu, "launches")]
    paddle.seed(0)
    t0 = time.perf_counter()
    net, main, startup, loss, feeds = _st_resnet_program(torch, BATCH)
    build_s = time.perf_counter() - t0

    exe = fluid.Executor()
    exe.run(startup)
    bufs0 = {k: v.clone() for k, v in main.buffers.items()}

    def window():
        out, = exe.run_steps(main, feed=feeds, fetch_list=[loss],
                             iterations=N_STEPS, fetch_every=N_STEPS,
                             constant_feeds=("image", "label"))
        return float(np.asarray(out)[-1])

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    w = st_windows(torch, exe, window, counters, "ST4")
    peak = torch.cuda.max_memory_allocated()
    want = {"conv1x1_bn_stats": RESNET_BLOCKS * N_STEPS,
            "bn_apply_relu": RESNET_BLOCKS * N_STEPS}
    assert all(c == want for c in w["counts"]), w["counts"]
    moved = [k for k, v in bufs0.items() if not torch.equal(v,
                                                            main.buffers[k])]
    assert len(moved) == len(bufs0), (len(moved), len(bufs0))
    assert all(v.dtype == torch.bfloat16 for v in main.buffers.values())
    rate = _st_summary(w["seconds"], BATCH * N_STEPS,
                       RESNET50_TRAIN_GFLOP_PER_IMG)
    step_ms = sorted(w["seconds"])[1] / N_STEPS * 1e3
    finals = [w["eager_final"], w["capture_final"]] + w["final"]
    log(f"ST4 bench_resnet50[{gpu}]: program built in {build_s:.1f} s; "
        f"windows of {N_STEPS} steps: eager {w['eager_s']:.3f} s, capture "
        f"+ replay {w['capture_s']:.3f} s, timed "
        f"{[round(s, 4) for s in w['seconds']]} s; final losses "
        f"{[round(v, 4) for v in finals]}; launches per timed window "
        f"{w['counts'][0]} (= {want}); {len(moved)} of {len(bufs0)} "
        f"BatchNorm buffers moved; peak device memory "
        f"{peak / 2**20:.0f} MiB")
    log(f"ST4 resnet50_train_img_per_sec_per_chip[{gpu}]: median "
        f"{rate['median']:.1f} (range {rate['min']:.1f}-{rate['max']:.1f}, "
        f"bench.py's best-window {rate['best']:.1f}) img/s = {step_ms:.2f} "
        f"ms a step; achieved {rate['achieved_tflops']:.1f} TFLOP/s at "
        f"12.3 GFLOP/img ({rate['mfu_vs_h100_dense_bf16_989']:.3f} of the "
        f"H100's dense bf16 989 TFLOP/s); beside Model.train_batch (R3) "
        f"{eager['step_ms']:.2f} ms a step and fit(steps_per_execution=4) "
        f"(K3) {k3['step_ms']:.2f}")
    out = {"rate": rate, "step_ms": step_ms,
           "train_batch_step_ms": eager["step_ms"],
           "k3_step_ms": k3["step_ms"], "windows": w, "peak_bytes": peak,
           "launches": w["counts"][-1]}
    del exe, main, startup, net, feeds
    gc.collect()
    torch.cuda.empty_cache()
    return out


def static_graph_phases(torch, gpu, bert, resnet, k3, k4):
    """Phases ST1-ST5: bench.py's configs 1-3 through the 1.x static graph
    (``fluid.Program`` / ``program_guard`` / ``layer_op`` /
    ``record_call`` / ``minimize`` / ``Executor.run`` and ``run_steps``);
    ST5 is the line of their numbers under bench.py's names."""
    st1 = st_mnist(torch, gpu)
    submark("ST2")
    st2 = st_example(torch, gpu)
    submark("ST3")
    st3 = st_bert(torch, gpu, bert, k4)
    submark("ST4")
    st4 = st_resnet(torch, gpu, resnet, k3)
    line = {"static_graph": {
        "device": gpu,
        "mnist_mlp_smoke_accuracy": st1["mnist_mlp_smoke_accuracy"],
        "bert_base_train_seq_per_sec_per_chip": dict(
            st3["rate"], unit="seq/s", step_ms=st3["step_ms"],
            chain_len=ST_BERT_STEPS,
            train_batch_step_ms=st3["train_batch_step_ms"],
            k4_step_ms=st3["k4_step_ms"], peak_bytes=st3["peak_bytes"]),
        "resnet50_train_img_per_sec_per_chip": dict(
            st4["rate"], unit="img/s", step_ms=st4["step_ms"],
            chain_len=ST_RESNET_STEPS,
            train_batch_step_ms=st4["train_batch_step_ms"],
            k3_step_ms=st4["k3_step_ms"], peak_bytes=st4["peak_bytes"]),
        "example_static_graph_1x": st2, "mnist": st1}}
    log(json.dumps(line))
    return {"bert": st3, "resnet": st4}


# -- batched multi-LoRA and multi-tenant serving (A1-A5) ----------------------
LORA_CAP, LORA_RANK = 16, 8
LORA_SITES = ("qkv", "out", "fc1", "fc2")  # two kernel-10 hops a site a call
A_REQUESTS = 34                # two a slot: the base (-1) and 16 adapters
A_SAMPLE = 8                   # requests held against the merged model
A_PASSES = 1                   # timed passes of the trace a capacity in A5
A_CAPS = (0, 1, 4, 16)
LORA_BENCH = dict(vocab_size=8192, hidden_size=256, num_layers=4,
                  num_heads=8, max_position=512, dropout=0.0)
# A2: the batched logits against the dense-merged model, per element:
# |got - ref| <= LORA_MERGE_TOL x max|ref| (float32 products associated
# differently: x (W + A B) against x W + (x A) B)
LORA_MERGE_TOL = 1e-4


def lora_hop_shapes():
    """(cap, N, D, F) of both hops of every adapted linear the A phases
    run: gpt_small (cap 16: A2-A4) and bench.py's 4 x 256 config (cap 1,
    4, 16: A5), N = 8 (decode), 40 (the 1 + 4 verify step), 128 / 384
    (admission at buckets 16 / 48; A2's 4 x 32 rows), and at gpt_small the
    batch-1 engine's 1 / 5 / 16 / 48 (A4)."""
    out = set()
    for cap, dims, rows in (
            (LORA_CAP, gpt_site_dims(768, 3072),
             (1, 5, 8, 16, 40, 48, 128, 384)),
            *((c, gpt_site_dims(256, 1024), (8, 40, 128, 384))
              for c in (1, 4, 16))):
        for n in rows:
            for din, dout in dims:
                out.add((cap, n, din, LORA_RANK))
                out.add((cap, n, LORA_RANK, dout))
    return sorted(out)


def gpt_site_dims(hidden, ffn):
    """(in, out) of qkv, out, fc1, fc2."""
    return ((hidden, 3 * hidden), (hidden, hidden), (hidden, ffn),
            (ffn, hidden))


@contextlib.contextmanager
def lora_path_shapes():
    """Record the shapes the LoRA path hands kernel 10: a pass-through
    around ``lora/batched.py``'s ``grouped_matmul`` (both hops call it by
    that name) that launches and counts nothing itself."""
    from paddle_tpu_torch.lora import batched

    seen = set()
    gmm = batched.grouped_matmul

    def rec(x, w, gs):
        seen.add((int(x.shape[0]), int(x.shape[1]), int(x.shape[2]),
                  int(w.shape[2]), str(x.dtype)[6:]))
        return gmm(x, w, gs)

    batched.grouped_matmul = rec
    try:
        yield seen
    finally:
        batched.grouped_matmul = gmm


def lora_counts(torch, cap, n, gen, kind="random"):
    """Group sizes of ``n`` rows over ``cap`` slots as the dispatch gives
    them: ``random`` ids in [-1, cap), ``dead`` all -1, ``one`` all in the
    last slot."""
    if kind == "dead":
        ids = torch.full((n,), -1)
    elif kind == "one":
        ids = torch.full((n,), cap - 1)
    else:
        ids = torch.randint(-1, cap, (n,), generator=gen)
    return torch.stack([(ids == g).sum() for g in range(cap)]).to(
        DEVICE, torch.int32)


def check_lora_gmm(torch, shapes, label, dtype="float32", kinds=("random",)):
    """Kernel 10 against ``grouped_matmul_ref`` at LoRA hop shapes (padding
    rows NaN; two launches bit-equal; GMM_TOL).  Returns the largest
    error."""
    import importlib

    gmm = importlib.import_module("paddle_tpu_torch.ops.grouped_matmul")
    gen = torch.Generator().manual_seed(SEED + 61)
    worst, worst_share = 0.0, 0.0
    with torch.no_grad():
        for cap, n, D, F in shapes:
            for kind in kinds:
                gs = lora_counts(torch, cap, n, gen, kind)
                x, w, gs = gmm_inputs(torch, cap, n, D, F, gs.cpu(),
                                      getattr(torch, dtype), gen)
                err, share = gmm_check(torch, gmm, x, w, gs, dtype)
                worst, worst_share = max(worst, err), max(worst_share, share)
    log(f"{label}: kernel grouped_matmul at {len(shapes)} LoRA hop shapes "
        f"x {list(kinds)} {dtype}: max_abs_err={worst:.3e}, largest share of "
        f"the tolerance {worst_share:.3f}; two launches bit-equal, padding "
        f"rows 0; ok")
    return worst


def check_lora_kernel(torch):
    """Phase A1: kernel 10 against its plain version at every hop shape
    the A phases run (``lora_hop_shapes``: ranks 8 as the output and as the
    inner width, caps 1 / 4 / 16, N = 8 / 40 / 128 / 384, gpt_small's and
    bench.py's widths) with random ids, float32; all rows dead and all
    rows in one group at gpt_small's decode and admission shapes; a bf16
    case of both hops."""
    shapes = lora_hop_shapes()
    errs = {"float32": check_lora_gmm(torch, shapes, "A1")}
    edges = [s for s in shapes if s[0] == LORA_CAP and s[1] in (8, 384)
             and 768 in (s[2], s[3])]
    errs["edges"] = check_lora_gmm(torch, edges, "A1[edges]",
                                   kinds=("dead", "one"))
    errs["bfloat16"] = check_lora_gmm(
        torch, [(LORA_CAP, 8, 768, 8), (LORA_CAP, 8, 8, 2304),
                (4, 384, 768, 8), (4, 384, 8, 3072)], "A1[bf16]",
        dtype="bfloat16", kinds=("random", "one"))
    return {"shapes": len(shapes), "edge_shapes": len(edges),
            "max_abs_err": errs}


def check_lora_path(torch, seen, held, label):
    """Every shape a phase handed kernel 10 is one A1 held; a shape A1 did
    not list is held now.  Returns the shapes as strings."""
    extra = sorted((c, n, d, f) for c, n, d, f, dt in seen
                   if dt != "float32" or (c, n, d, f) not in held)
    if extra:
        check_lora_gmm(torch, extra, f"{label}[not in A1]")
    assert all(dt == "float32" for *_, dt in seen), seen
    return [f"[{c}, {n}, {d}] x [{c}, {d}, {f}]" for c, n, d, f, _ in
            sorted(seen)]


def lora_model(torch, cap=LORA_CAP, **kw):
    """``GPTForCausalLM(gpt_small(lora_capacity=cap, lora_rank=8))`` f32,
    seeded random weights."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_small

    return GPTForCausalLM(
        gpt_small(dropout=0.0, lora_capacity=cap, lora_rank=LORA_RANK, **kw),
        device=DEVICE, generator=torch.Generator().manual_seed(SEED)).eval()


def lora_adapters(model, n, std, seed0):
    from paddle_tpu_torch.lora import random_adapter

    return [random_adapter(model, f"a{s}", rank=LORA_RANK, seed=seed0 + s,
                           std=std) for s in range(n)]


class MergedModel:
    """``model`` called with ``merge_adapter``'s parameters bound
    (``torch.func.functional_call``): the dense-merged single-adapter
    reference."""

    def __init__(self, torch, model, adapter):
        from paddle_tpu_torch.lora import merge_adapter

        self._torch, self._model = torch, model
        self._params = (None if adapter is None
                        else merge_adapter(model, adapter))
        self.device = model.device

    def __call__(self, ids):
        if self._params is None:
            return self._model(ids)
        return self._torch.func.functional_call(self._model, self._params,
                                                (ids,))


def lora_math(torch, gpu, model):
    """Phase A2: ``model`` (``lora_model``: gpt_small(lora_capacity=16,
    lora_rank=8) f32) with a seeded adapter written into its slot 0 (and
    cleared after): logits of a [4, 32] batch under ids [0] x 4 against
    the merged model (``LORA_MERGE_TOL``); ids -1 bitwise the unscoped
    model; a mixed batch's base rows bitwise; kernel 10 96 launches a
    forward (4 sites x 12 layers x 2 hops)."""
    from paddle_tpu_torch.lora import adapter_scope
    from paddle_tpu_torch.lora.batched import _clear_slot, _write_slot
    from paddle_tpu_torch.ops import grouped_matmul

    cfg = model.gpt.cfg
    adp = lora_adapters(model, 1, 0.05, SEED + 60)[0]
    tables = dict(model.named_buffers())
    with torch.no_grad():
        _write_slot(tables, 0, adp)
    ids = torch.randint(0, cfg.vocab_size, (4, 32),
                        generator=torch.Generator().manual_seed(SEED + 62)
                        ).to(DEVICE)
    with torch.no_grad():
        base = model(ids)
        grouped_matmul.launches = 0
        with adapter_scope(torch.zeros(4, dtype=torch.int32, device=DEVICE)):
            got = model(ids)
        with adapter_scope([-1] * 4):
            dead = model(ids)
        with adapter_scope([0, -1, 0, -1]):
            mixed = model(ids)
        torch.cuda.synchronize()
        launches = grouped_matmul.launches
        ref = MergedModel(torch, model, adp)(ids)
    per_call = 2 * len(LORA_SITES) * cfg.num_layers
    assert launches == 3 * per_call, (launches, per_call)
    err = float((got - ref).abs().max())
    allowed = LORA_MERGE_TOL * float(ref.abs().max())
    moved = float((got - base).abs().max())
    log(f"A2[{gpu}]: gpt_small(lora_capacity={cfg.lora_capacity}, "
        f"lora_rank={cfg.lora_rank}) f32, adapter in slot 0: logits under "
        f"ids 0 vs the merged model max_abs_err={err:.3e} (allowed "
        f"{allowed:.3e} = {LORA_MERGE_TOL:g} x max|ref|), the adapter moved "
        f"them by {moved:.3e}; ids -1 bitwise the unscoped model: "
        f"{bool(torch.equal(dead, base))}; a mixed batch's base rows "
        f"bitwise: {bool(torch.equal(mixed[1::2], base[1::2]))}; "
        f"grouped_matmul launches {launches} = {per_call} x 3 forwards")
    assert err <= allowed and moved > 10 * allowed, (err, allowed, moved)
    assert torch.equal(dead, base) and torch.equal(mixed[1::2], base[1::2])
    assert torch.allclose(mixed[0::2], got[0::2], rtol=0, atol=allowed)
    with torch.no_grad():
        _clear_slot(tables, 0)
    return {"max_abs_err": err, "allowed": allowed, "moved": moved,
            "launches": launches, "launches_per_forward": per_call}


def lora_requests(vocab, n=A_REQUESTS, seed=SEED + 63, new=(8, 17)):
    """``n`` seeded requests (prompts of 4-48 tokens, ``new`` tokens),
    round-robin over the slots -1, 0, ..., 15."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, size=rng.randint(4, 49)).astype(np.int32),
             int(rng.randint(*new)), (i % (LORA_CAP + 1)) - 1)
            for i in range(n)]


def engine_counts(st, st0, per_call, layers):
    calls = ((st["batches"] - st0["batches"])
             + (st["decode_steps"] - st0["decode_steps"]))
    return calls, per_call * calls, layers * calls


def lora_engine(torch, gpu, model):
    """Phase A3: the multi-tenant paged engine over ``model`` (gpt_small
    width, phase 4's engine settings) with 16 adapters installed: 34
    requests
    round-robin over the base and the 16 slots, all in flight; kernel 10
    96 and kernel 1 12 launches a call; every request's tokens bit-equal
    to the same engine serving it alone; 8 requests against uncached
    greedy of the merged model (near-ties only); hot installs and a
    removal while requests are in flight, the removed slot then serving
    the base tokens."""
    from paddle_tpu_torch.ops import grouped_matmul
    from paddle_tpu_torch.ops.paged_attention import paged_flash_decode
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = model.gpt.cfg
    adps = lora_adapters(model, LORA_CAP, 0.05, SEED + 100)
    reqs = lora_requests(cfg.vocab_size)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    with GenerationEngine(model, name="chip-smoke-A3", **ENGINE) as eng:
        for s, a in enumerate(adps):
            eng.install_adapter(s, a)
        t0 = time.monotonic()
        eng.warmup()
        log(f"A3: {LORA_CAP} adapters installed, warmup "
            f"{time.monotonic() - t0:.2f}s")
        st0 = eng.stats()
        grouped_matmul.launches = paged_flash_decode.launches = 0
        t0 = time.monotonic()
        futs = [eng.submit(p, n, adapter_id=a) for p, n, a in reqs]
        outs = [f.result(600).tolist() for f in futs]
        wall = time.monotonic() - t0
        launches = (grouped_matmul.launches, paged_flash_decode.launches)
        st = eng.stats()
        calls, want_gmm, want_paged = engine_counts(
            st, st0, 2 * len(LORA_SITES) * cfg.num_layers, cfg.num_layers)
        log(f"A3[{gpu}]: {len(reqs)} requests over {LORA_CAP + 1} slots, "
            f"{sum(map(len, outs))} tokens in {wall:.3f}s = "
            f"{sum(map(len, outs)) / wall:.1f} tokens/s, {calls} calls; "
            f"grouped_matmul launches {launches[0]} (= "
            f"{2 * len(LORA_SITES) * cfg.num_layers} x calls: "
            f"{launches[0] == want_gmm}), paged_flash_decode {launches[1]} "
            f"(= {cfg.num_layers} x calls: {launches[1] == want_paged})")
        assert launches == (want_gmm, want_paged), (launches, calls)
        assert st["completed"] - st0["completed"] == len(reqs), st
        # each request alone, on the same engine
        serial = [eng.generate(p, n, timeout=600, adapter_id=a).tolist()
                  for p, n, a in reqs]
        same = sum(a == b for a, b in zip(outs, serial))
        log(f"A3: {same} of {len(reqs)} requests bit-identical to the same "
            f"engine serving them alone")
        assert same == len(reqs)
        base_of = {i: eng.generate(p, n, timeout=600).tolist()
                   for i, (p, n, a) in enumerate(reqs[:A_SAMPLE + 1])
                   if a >= 0}
        moved = sum(outs[i] != b for i, b in base_of.items())
        log(f"A3: the adapters change the tokens of {moved} of "
            f"{len(base_of)} adapted requests")
        # hot edits while requests are in flight
        live = [eng.submit(p, n, adapter_id=a) for p, n, a in reqs[:16]]
        eng.install_adapter(LORA_CAP - 1, adps[0])
        eng.remove_adapter(LORA_CAP - 2)
        eng.install_adapter(LORA_CAP - 3, adps[1])
        hot = [f.result(600) for f in live]
        p, n, _ = reqs[1]
        removed = eng.generate(p, n, timeout=600,
                               adapter_id=LORA_CAP - 2).tolist()
        assert removed == eng.generate(p, n, timeout=600).tolist()
        st = eng.stats()
        assert st["errors"] == 0 and st["kv_pages_leaked"] == 0, st
        assert st["adapter_installs"] == LORA_CAP + 2
        assert st["adapter_removals"] == 1
        assert len(eng.adapters) == LORA_CAP - 1
        log(f"A3: 3 hot edits with {len(hot)} requests in flight: no "
            f"error, the removed slot serves the base tokens; adapters "
            f"{len(eng.adapters)}, installs {st['adapter_installs']}, "
            f"removals {st['adapter_removals']}")
    peak = torch.cuda.max_memory_allocated()
    compared = ties = 0
    with torch.no_grad():
        for (p, _, a), out in list(zip(reqs, outs))[:A_SAMPLE]:
            ref = MergedModel(torch, model, adps[a] if a >= 0 else None)
            c, t = greedy_margin_check(torch, ref, p, out, cfg.vocab_size)
            compared += c
            ties += t
            del ref
    log(f"A3: {compared} tokens of {A_SAMPLE} requests agree with uncached "
        f"greedy of the merged model ({ties} near-tie divergences), peak "
        f"device memory {peak / 2**20:.0f} MiB")
    assert compared >= 40, compared
    return {"requests": len(reqs), "calls": calls, "launches": launches[0],
            "paged_launches": launches[1],
            "tokens_per_s": sum(map(len, outs)) / wall,
            "serial_equal": same, "greedy_tokens_compared": compared,
            "adapted_requests_moved": moved, "peak_bytes": peak}


def lora_tenancy(torch, gpu, model):
    """Phase A4: a ``TenantScheduler`` (two weighted tenants and a metered
    one) on A3's ``model``: a metered request preempted mid-decode by an
    emptied budget regenerates its uncontended tokens bit for bit beside
    the weighted tenants' requests, which equal serial; the dense-ring and
    legacy engines with adapters give the tokens they give one request at
    a time, kernel 10 96 launches a call; an int8 LoRA engine at batch 1
    runs kernels 9 and 10 (48 and 96 a call)."""
    from paddle_tpu_torch.ops import grouped_matmul
    from paddle_tpu_torch.ops.paged_attention import paged_flash_decode
    from paddle_tpu_torch.ops.quantized_matmul import quantized_linear
    from paddle_tpu_torch.serving import (GenerationEngine, TenantScheduler,
                                          TenantSpec)

    cfg = model.gpt.cfg
    per_call = 2 * len(LORA_SITES) * cfg.num_layers
    adps = lora_adapters(model, 3, 0.05, SEED + 100)
    reqs = lora_requests(cfg.vocab_size, n=12, seed=SEED + 64)
    out = {}
    ten = TenantScheduler([TenantSpec("gold", weight=2.0, adapter_id=0),
                           TenantSpec("free", adapter_id=1),
                           TenantSpec("metered", token_budget=50,
                                      refill_per_s=500.0, adapter_id=2)])
    with GenerationEngine(model, name="chip-smoke-A4", tenancy=ten,
                          **ENGINE) as eng:
        for s, a in enumerate(adps):
            eng.install_adapter(s, a)
        eng.warmup()
        p_m = reqs[0][0]
        ref_m = eng.generate(p_m, 40, timeout=600, adapter_id=2).tolist()
        serial = [eng.generate(p, n, timeout=600, adapter_id=i % 2).tolist()
                  for i, (p, n, _) in enumerate(reqs[1:])]
        st0 = eng.stats()
        fut = eng.submit(p_m, 40, tenant="metered")
        futs = [eng.submit(p, n, tenant=("gold", "free")[i % 2])
                for i, (p, n, _) in enumerate(reqs[1:])]
        deadline = time.monotonic() + 60
        while (time.monotonic() < deadline and
               eng.stats()["decode_steps"] - st0["decode_steps"] < 3):
            time.sleep(0.002)
        ten.charge("metered", 200)  # empty the bucket: preempt the slot
        got_m = fut.result(600).tolist()
        got = [f.result(600).tolist() for f in futs]
        st = eng.stats()
    snap = ten.snapshot()
    log(f"A4[{gpu}]: tenancy: metered request preempted "
        f"{st['tenant_preempted']} time(s), regenerated its uncontended "
        f"tokens bit for bit: {got_m == ref_m}; gold / free requests equal "
        f"serial: {sum(a == b for a, b in zip(got, serial))} of "
        f"{len(got)}; kv_pages_leaked {st['kv_pages_leaked']}; tenants "
        f"{ {k: (v['admitted'], v['tokens'], v['preempted']) for k, v in snap.items()} } "
        f"(admitted, tokens, preempted)")
    assert got_m == ref_m and got == serial, "tenancy changed tokens"
    assert st["tenant_preempted"] >= 1 and st["kv_pages_leaked"] == 0, st
    out["tenancy"] = {"tenant_preempted": st["tenant_preempted"],
                      "tenant_throttled_steps": st["tenant_throttled_steps"],
                      "tenants": snap}
    # the dense-ring and legacy engines with adapters
    for kind, kw in (("dense", {}), ("legacy", dict(continuous=False))):
        with GenerationEngine(model, prompt_buckets=[16, 48], batch_size=8,
                              max_queue_delay_ms=20.0,
                              name=f"chip-smoke-A4-{kind}", **kw) as eng:
            for s, a in enumerate(adps):
                eng.install_adapter(s, a)
            eng.warmup()
            st0 = eng.stats()
            grouped_matmul.launches = paged_flash_decode.launches = 0
            futs = [eng.submit(p, n, adapter_id=(i % 4) - 1)
                    for i, (p, n, _) in enumerate(reqs)]
            got = [f.result(600).tolist() for f in futs]
            launches = grouped_matmul.launches
            # the legacy batcher books a batch just after its futures
            deadline = time.monotonic() + 30
            while (eng.stats()["completed"] - st0["completed"] < len(reqs)
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            st = eng.stats()
            alone = [eng.generate(p, n, timeout=600,
                                  adapter_id=(i % 4) - 1).tolist()
                     for i, (p, n, _) in enumerate(reqs)]
        calls, want, _ = engine_counts(st, st0, per_call, cfg.num_layers)
        same = sum(a == b for a, b in zip(got, alone))
        log(f"A4[{gpu}]: {kind} engine with adapters: {same} of {len(reqs)} "
            f"requests equal the same engine serving them alone; "
            f"grouped_matmul launches {launches} (= {per_call} x {calls} "
            f"calls: {launches == want}), paged_flash_decode "
            f"{paged_flash_decode.launches}")
        assert same == len(reqs) and launches == want, (same, launches)
        assert paged_flash_decode.launches == 0
        out[kind] = {"calls": calls, "launches": launches,
                     "equal_alone": same}
    # int8 + LoRA at batch 1 (quantized activation scales see the batch)
    with GenerationEngine(model, name="chip-smoke-A4-int8",
                          quantized="int8",
                          **dict(ENGINE, batch_size=1)) as eng:
        for s, a in enumerate(adps):
            eng.install_adapter(s, a)
        eng.warmup()
        st0 = eng.stats()
        grouped_matmul.launches = quantized_linear.launches = 0
        paged_flash_decode.launches = 0
        got = {a: [eng.generate(p, 12, timeout=600, adapter_id=a).tolist()
                   for p, _, _ in reqs[:2]] for a in (-1, 0)}
        launches = (grouped_matmul.launches, quantized_linear.launches,
                    paged_flash_decode.launches)
        st = eng.stats()
    calls, want, want_paged = engine_counts(st, st0, per_call,
                                            cfg.num_layers)
    want_qmm = len(LORA_SITES) * cfg.num_layers * calls
    log(f"A4[{gpu}]: int8 LoRA engine, batch 1: grouped_matmul {launches[0]}"
        f" (= {per_call} x {calls} calls: {launches[0] == want}), "
        f"quantized_matmul {launches[1]} (= {len(LORA_SITES) * cfg.num_layers}"
        f" x calls: {launches[1] == want_qmm}), paged_flash_decode "
        f"{launches[2]} (= {cfg.num_layers} x calls); the adapter changes "
        f"tokens: {got[0] != got[-1]}")
    assert launches == (want, want_qmm, want_paged), launches
    out["int8"] = {"calls": calls, "launches": launches[0],
                   "qmm_launches": launches[1]}
    return out


def lora_bench_model(torch, cap):
    """bench.py's multi-LoRA model: its ``GPTConfig`` at ``cap`` slots,
    rank 8, drawn after ``paddle_tpu_torch.seed(1234)``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    paddle.seed(1234)
    model = GPTForCausalLM(GPTConfig(**LORA_BENCH, lora_capacity=cap,
                                     lora_rank=LORA_RANK))
    return model.eval()


def lora_bench_engine(model, cap):
    """bench.py's engine for the multi-LoRA workload, the ``cap`` seeded
    adapters installed (``random_adapter(..., rank=8, seed=100 + s)``)."""
    from paddle_tpu_torch.lora import random_adapter
    from paddle_tpu_torch.serving import GenerationEngine

    eng = GenerationEngine(model, prompt_buckets=[16, 48], batch_size=8,
                           max_queue_delay_ms=1.0, continuous=True,
                           paged=True, name=f"bench-gen-lora{cap}")
    for s in range(cap):
        eng.install_adapter(s, random_adapter(
            model, f"bench-a{s}", rank=LORA_RANK, seed=100 + s))
    return eng


def lora_trace_pass(eng, trace, cap):
    """One pass of ``RequestTrace.synthetic()``, requests round-robin over
    the slots (one tenant a slot), as bench.py sends them: (tokens/s,
    {tenant: p99 ms}, outputs)."""
    import numpy as np

    lat, futs = {}, []
    t0 = time.perf_counter()
    for i, (prompt, max_new) in enumerate(trace):
        aid = (i % cap) if cap else -1
        tn = f"tenant-{aid}" if aid >= 0 else "base"
        ts = time.perf_counter()
        f = eng.submit(prompt, max_new, **({"adapter_id": aid} if cap
                                           else {}))
        f.add_done_callback(lambda _, ts=ts, tn=tn: lat.setdefault(
            tn, []).append(time.perf_counter() - ts))
        futs.append(f)
    outs = [f.result(600).tolist() for f in futs]
    seconds = time.perf_counter() - t0
    p99 = {tn: float(np.percentile(np.asarray(v) * 1e3, 99))
           for tn, v in lat.items()}
    return sum(map(len, outs)) / seconds, p99, outs


def lora_gather_ms(torch):
    """bench.py's microbench in the port: ``lora_delta`` at a decode-step
    linear ([8, 256] rows, a 16-slot rank-8 table, ids arange(8) % 16)
    against the base matmul ``x @ w`` [256, 256], by CUDA events."""
    import numpy as np

    from paddle_tpu_torch.lora.batched import lora_delta

    B_, cap, hidden = 8, 16, LORA_BENCH["hidden_size"]
    rng = np.random.RandomState(7)

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).to(DEVICE)

    A = dev(rng.randn(cap, hidden, LORA_RANK) * 0.02)
    Bw = dev(rng.randn(cap, LORA_RANK, hidden) * 0.02)
    scale = torch.ones(cap, device=DEVICE)
    ids = torch.from_numpy(np.arange(B_) % cap).to(DEVICE, torch.int32)
    w = dev(rng.randn(hidden, hidden) * 0.02)
    x = dev(rng.randn(B_, hidden))
    with torch.no_grad():
        gather = runs_ms(torch, lambda a: lora_delta(A, Bw, scale, a, ids)[0],
                         [(x,)], 200)
        base = runs_ms(torch, lambda a: a @ w, [(x,)], 200)
    return gather, base


def bench_multilora(torch, gpu):
    """Phase A5: bench.py's ``bench_gpt_generate_multilora`` in the port —
    its config at caps 0, 1, 4, 16 (``lora_bench_model``), its engine
    (``lora_bench_engine``), ``RequestTrace.synthetic()`` round-robin over
    the slots, ``A_PASSES`` passes a cap (tokens/s and the worst tenant's
    p99 as the median and range of the passes), kernel 10 32 and kernel 1
    4 launches a call at cap 16, the 16-adapter engine's tokens against
    the same engine serving each request alone, its busy share, and
    ``adapter_gather_ms`` / ``base_matmul_ms``.  Prints a line under
    bench.py's names."""
    from paddle_tpu_torch.ops import grouped_matmul
    from paddle_tpu_torch.ops.paged_attention import paged_flash_decode
    from paddle_tpu_torch.tuning import RequestTrace

    trace = RequestTrace.synthetic()
    by_cap, extra = {}, {}
    for cap in A_CAPS:
        model = lora_bench_model(torch, cap)
        cfg = model.gpt.cfg
        with lora_bench_engine(model, cap) as eng:
            eng.warmup()
            st0 = eng.stats()
            grouped_matmul.launches = paged_flash_decode.launches = 0
            passes = [lora_trace_pass(eng, trace, cap)
                      for _ in range(A_PASSES)]
            launches = (grouped_matmul.launches, paged_flash_decode.launches)
            st = eng.stats()
            calls, want, want_paged = engine_counts(
                st, st0, 2 * len(LORA_SITES) * cfg.num_layers if cap else 0,
                cfg.num_layers)
            assert launches == (want, want_paged), (cap, launches, calls)
            assert st["errors"] == 0 and st["kv_pages_leaked"] == 0, st
            outs = passes[0][2]
            repeat = sum(a == b for later in passes[1:]
                         for a, b in zip(later[2], outs))
            if cap == LORA_CAP:
                alone = [eng.generate(p, n, timeout=600,
                                      adapter_id=i % cap).tolist()
                         for i, (p, n) in enumerate(trace)]
                same = sum(a == b for a, b in zip(outs, alone))
                busy, window = busy_share(torch, lambda: lora_trace_pass(
                    eng, trace, cap))
                extra = {"serial_equal": same, "busy_ms": busy,
                         "window_ms": window, "busy_share": busy / window,
                         "calls": calls, "launches": launches[0],
                         "paged_launches": launches[1]}
                log(f"A5: 16-adapter engine: {same} of {len(trace)} "
                    f"requests bit-identical to the same engine serving "
                    f"them alone; device busy {busy:.1f} ms of a "
                    f"{window:.1f} ms profiled pass = "
                    f"{100 * busy / window:.1f}%")
                assert same == len(trace)
        rates = sorted(p[0] for p in passes)
        worst = sorted(max(p[1].values()) for p in passes)
        by_cap[cap] = {"tokens_per_s": rates[len(rates) // 2],
                       "tokens_per_s_range": [rates[0], rates[-1]],
                       "p99_ms_worst": worst[len(worst) // 2],
                       "p99_ms_worst_range": [worst[0], worst[-1]],
                       "calls": calls, "grouped_matmul_launches": launches[0],
                       "paged_launches": launches[1],
                       "later_passes_equal_to_first": repeat}
        log(f"A5[{gpu}]: cap {cap}: median {rates[len(rates) // 2]:.1f} "
            f"tokens/s (range {rates[0]:.1f}-{rates[-1]:.1f}) over "
            f"{A_PASSES} passes, worst tenant p99 median "
            f"{worst[len(worst) // 2]:.1f} ms (range {worst[0]:.1f}-"
            f"{worst[-1]:.1f}); {calls} calls, grouped_matmul {launches[0]} "
            f"(= {2 * len(LORA_SITES) * cfg.num_layers if cap else 0} x "
            f"calls), paged_flash_decode {launches[1]} (= {cfg.num_layers} x "
            f"calls); later "
            f"passes equal to the first in {repeat} of "
            f"{len(trace) * (A_PASSES - 1)} requests")
        del model
        gc.collect()
    gather, base = lora_gather_ms(torch)
    tps = {c: by_cap[c]["tokens_per_s"] for c in A_CAPS}
    line = {"metric": "gpt_generate_multilora_tokens_per_sec",
            "value": round(tps[16], 1), "unit": "tok/s",
            "vs_baseline": round(tps[16] / tps[0], 3),
            "base_tokens_per_sec": round(tps[0], 1),
            "tokens_per_sec_1": round(tps[1], 1),
            "tokens_per_sec_4": round(tps[4], 1),
            "tokens_per_sec_16": round(tps[16], 1),
            "base_p99_ms": round(by_cap[0]["p99_ms_worst"], 1),
            "tenant_p99_ms_worst_1": round(by_cap[1]["p99_ms_worst"], 1),
            "tenant_p99_ms_worst_4": round(by_cap[4]["p99_ms_worst"], 1),
            "tenant_p99_ms_worst_16": round(by_cap[16]["p99_ms_worst"], 1),
            "adapter_gather_ms": round(gather[0], 4),
            "base_matmul_ms": round(base[0], 4),
            "adapter_gather_share": round(
                gather[0] / max(gather[0] + base[0], 1e-9), 3),
            "busy_share": round(extra["busy_share"], 4),
            "passes": A_PASSES, "requests": len(trace),
            "new_tokens": trace.total_new_tokens,
            "method": "multilora_vs_base_same_trace", "device": gpu}
    log(json.dumps(line))
    log(f"A5: adapter_gather_ms {_spread(gather)}, base_matmul_ms "
        f"{_spread(base)} (median (min-max) of {TIMING_RUNS} runs, eager)")
    return dict(line, by_cap=by_cap, **extra)


def timing_lora_gmm(torch, gpu):
    """Kernel 10 at the LoRA hop shapes of the A phases' decode (N = 8)
    and admission (N = 384) calls, gpt_small's and bench.py's widths, by
    CUDA graph (device time; the eager call is Python-bound): kernel,
    plain version and ``torch.bmm`` over the full buffers, median (min-
    max) of 3 runs, beside the bound.  Group sizes: 8 distinct slots of
    the 16, N / 8 rows each."""
    import importlib

    gmm = importlib.import_module("paddle_tpu_torch.ops.grouped_matmul")
    gen = torch.Generator().manual_seed(SEED + 65)
    cases = [("gpt_small_decode_hop1_qkv", LORA_CAP, 8, 768, 8),
             ("gpt_small_decode_hop2_qkv", LORA_CAP, 8, 8, 2304),
             ("gpt_small_decode_hop1_fc2", LORA_CAP, 8, 3072, 8),
             ("gpt_small_decode_hop2_fc1", LORA_CAP, 8, 8, 3072),
             ("gpt_small_admit384_hop1_qkv", LORA_CAP, 384, 768, 8),
             ("gpt_small_admit384_hop2_qkv", LORA_CAP, 384, 8, 2304),
             ("bench_decode_hop1_qkv", LORA_CAP, 8, 256, 8),
             ("bench_decode_hop2_qkv", LORA_CAP, 8, 8, 768)]
    rows = {}
    with torch.no_grad():
        for name, cap, n, D, F in cases:
            gs = torch.zeros(cap, dtype=torch.int32)
            gs[torch.arange(8) * 2 % cap] = n // 8
            args = [gmm_inputs(torch, cap, n, D, F, gs, torch.float32, gen)
                    for _ in range(2)]
            b_ms, b_by, nbytes, flops = gmm_bound(gs, cap, n, D, F,
                                                  "float32")
            ms = graph_runs_ms(torch, gmm._forward_kernel, args, 50)
            plain = graph_runs_ms(torch, gmm.grouped_matmul_ref, args, 20)
            lib = graph_runs_ms(torch, lambda x, w, g: torch.bmm(x, w), args,
                                50)
            rows[name] = dict(ms=ms[0], plain_ms=plain[0], library_ms=lib[0],
                              bound_ms=b_ms, bound_by=b_by,
                              shape=f"[{cap}, {n}, {D}] x [{cap}, {D}, {F}]")
            log(f"timing[{gpu}] grouped_matmul float32 LoRA {name} [{cap}, "
                f"{n}, {D}] x [{cap}, {D}, {F}] gs={gs.tolist()}: kernel "
                f"{_spread(ms)} ms, plain {_spread(plain)} ms, library "
                f"(torch.bmm, full buffers) {_spread(lib)} ms, bound "
                f"{b_ms:.5f} ms by {b_by} ({flops:.4g} flops, {nbytes} "
                f"bytes) (device time, CUDA graph)")
            del args
    return rows


def lora_phases(torch, gpu):
    """A1-A5 in order, the path's kernel-10 shapes recorded in A2-A5 and
    held against A1's; then the LoRA timing rows."""
    a1 = check_lora_kernel(torch)
    held = set(lora_hop_shapes())
    path = {}
    model = lora_model(torch)
    submark("A2")
    with lora_path_shapes() as seen:
        a2 = lora_math(torch, gpu, model)
    path["A2"] = check_lora_path(torch, seen, held, "A2")
    submark("A3")
    with lora_path_shapes() as seen:
        a3 = lora_engine(torch, gpu, model)
    path["A3"] = check_lora_path(torch, seen, held, "A3")
    submark("A4")
    with lora_path_shapes() as seen:
        a4 = lora_tenancy(torch, gpu, model)
    path["A4"] = check_lora_path(torch, seen, held, "A4")
    del model
    gc.collect()
    submark("A5")
    with lora_path_shapes() as seen:
        a5 = bench_multilora(torch, gpu)
    path["A5"] = check_lora_path(torch, seen, held, "A5")
    submark("A timing")
    rows = timing_lora_gmm(torch, gpu)
    log(json.dumps({"multilora": {
        "device": gpu, "A1": a1, "A2": a2, "A3": a3, "A4": a4,
        "A5": a5, "path_shapes": path}}))
    return {"A1": a1, "A2": a2, "A3": a3, "A4": a4, "A5": a5,
            "path": path, "rows": rows}


# -- the layer library: a long-document encoder (kernels 4-6), recompute, ----
# nn.Transformer, the LSTM LM, beam search (phases N1-N7)
# the long-document encoder: Transformer-base's encoder (Vaswani et al.
# 2017; nn.Transformer's own defaults) over 2 x 8192 tokens, its attention
# non-causal and unmasked with attn_dropout 0, so every layer takes the
# flash kernels behind flash_eligible
NN_B, NN_S, NN_V = 2, 8192, 32768
NN_D, NN_HEADS, NN_FF, NN_LAYERS = 512, 8, 2048, 6
NN_WARMUP, NN_STEPS = 2, 5
NN_LR = 3e-4
NN_F32_CASE = (2, 4, 384, 64)   # N1's small float32 non-causal shape
# N4: nn.Transformer() on a copy task
TR_B, TR_S, TR_V, TR_STEPS, TR_DECODE = 64, 64, 32768, 12, 16
# N5: Zaremba et al. 2014's medium LSTM language model
LM_LAYERS, LM_H, LM_V, LM_T, LM_B, LM_STEPS = 2, 650, 10000, 35, 20, 12
# N6: the JAX test's GRU seq2seq (copy task), then at H 512 / vocab 32768
S2S_V, S2S_H, S2S_T, S2S_N, S2S_STEPS = 12, 32, 5, 64, 120
BEAM_H, BEAM_V, BEAM_B, BEAM_K, BEAM_MAX = 512, 32768, 64, 4, 32
BEAM_SHARPEN = 30.0   # output weights scaled: top-k gaps well above rounding


def _flash_bounds(B, H, S, K, hd):
    """Non-causal: every (query, key) pair.  (forward, dq, dk / dv) as
    (flops, bytes): 4, 6 and 8 flops a pair a head dim; q, k, v (and dO)
    read and the outputs written once in bf16, lse / delta in float32."""
    pairs = B * H * S * K
    n = B * H * S * hd * 2
    stats = B * H * S * 4
    return {"fwd": (4.0 * pairs * hd, 4 * n + stats),
            "dq": (6.0 * pairs * hd, 5 * n + 2 * stats),
            "dkv": (8.0 * pairs * hd, 6 * n + 2 * stats)}


def _bound_row(flops, nbytes):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return dict(bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations")


def nn_flash_noncausal(torch, gpu):
    """Phase N1: kernels 4, 5 and 6 against their plain versions at the
    encoder's non-causal shape [2, 8, 8192, 64] bf16 (q, k, v as
    MultiHeadAttention hands them: contiguous [B, S, H, hd] viewed as [B,
    H, S, hd]) and at a small float32 non-causal shape; then timed by CUDA
    graph (median and range of 3) beside the eager call, the plain
    versions and F.scaled_dot_product_attention(is_causal=False)'s forward
    and backward, with each kernel's bound over all S x K pairs."""
    import importlib

    import torch.nn.functional as F

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    gen = torch.Generator().manual_seed(SEED + 70)
    B, H, S, hd = NN_B, NN_HEADS, NN_S, NN_D // NN_HEADS

    def mha_views(dtype):
        # [B, S, H, hd] contiguous, seen as [B, H, S, hd]: MHA's layout
        return tuple(torch.randn(B, S, H, hd, generator=gen).to(
            DEVICE, dtype).transpose(1, 2) for _ in range(3))

    errs, ratios = {}, {}
    q, k, v = mha_views(torch.bfloat16)
    errs["fwd"], ratios["fwd"], _ = flash_check(torch, fa, q, k, v, False,
                                                0, "bfloat16")
    do = torch.randn(B, H, S, hd, generator=gen).to(DEVICE, torch.bfloat16)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, False)
    berrs, bratio, _, _ = flash_bwd_check(
        torch, fa, (q, k, v, do, out, lse), False, 0, "bfloat16")
    errs.update(berrs)
    ratios["bwd"] = bratio
    log(f"N1 kernels 4-6 bf16 non-causal at the encoder's shape [{B}, {H}, "
        f"{S}, {hd}] (strided MHA views): forward max_abs_err "
        f"{errs['fwd']:.3e} ({ratios['fwd']:.3f} of {FLASH_TOL['bfloat16']}"
        f"), dq {berrs['dq']:.3e} dk {berrs['dk']:.3e} dv {berrs['dv']:.3e} "
        f"({bratio:.3f} of {FLASH_BWD_TOL['bfloat16']}); ok")
    del q, k, v, do, out, lse
    b2, h2, s2, d2 = NN_F32_CASE
    qf, kf, vf, dof, outf, lsef = bwd_inputs(torch, fa, b2, h2, s2, s2, d2,
                                             torch.float32, gen,
                                             causal=False)
    f32_fwd, _, _ = flash_check(torch, fa, qf, kf, vf, False, 0, "float32")
    f32_bwd, _, _, _ = flash_bwd_check(torch, fa, (qf, kf, vf, dof, outf,
                                                   lsef), False, 0,
                                       "float32")
    log(f"N1 kernels 4-6 float32 non-causal {list(NN_F32_CASE)}: forward "
        f"{f32_fwd:.3e}, dq/dk/dv {f32_bwd}; ok")
    gc.collect()
    torch.cuda.empty_cache()

    # timing: two copies of the inputs (rotated), bf16, contiguous
    scale = 1.0 / hd ** 0.5
    copies = []
    for _ in range(2):
        q, k, v, do = (torch.randn(B, H, S, hd, generator=gen).to(
            DEVICE, torch.bfloat16) for _ in range(4))
        out, lse = fa.flash_attention_fwd_lse(q, k, v, False)
        delta = (do.float() * out.float()).sum(-1)
        copies.append((q, k, v, do, out, lse, delta))
    bounds = _flash_bounds(B, H, S, S, hd)
    iters = 10
    rows = {}
    with torch.no_grad():
        fwd = graph_runs_ms(torch, lambda q, k, v, *_:
                            fa.flash_attention_fwd_lse(q, k, v, False),
                            copies, iters)
        fwd_eager = runs_ms(torch, lambda q, k, v, *_:
                            fa.flash_attention_fwd_lse(q, k, v, False),
                            copies, iters)
        dq = graph_runs_ms(torch, lambda q, k, v, do, o, l, d:
                           fa.flash_attention_bwd_dq(q, k, v, do, l, d,
                                                     False, scale, 0),
                           copies, iters)
        dkv = graph_runs_ms(torch, lambda q, k, v, do, o, l, d:
                            fa.flash_attention_bwd_dkv(q, k, v, do, l, d,
                                                       False, scale, 0),
                            copies, iters)
        bwd_eager = runs_ms(torch, lambda q, k, v, do, o, l, d:
                            fa.flash_attention_bwd_chunk(q, k, v, o, l, do,
                                                         False), copies,
                            iters)
        plain_fwd = runs_ms(torch, lambda q, k, v, *_:
                            fa.flash_attention_fwd_lse_ref(q, k, v, False),
                            copies, 2)
        plain_bwd = runs_ms(torch, lambda q, k, v, do, o, l, d:
                            fa.flash_attention_bwd_ref(q, k, v, o, l, do,
                                                       False, delta=d),
                            copies, 2)
        lib_fwd = runs_ms(torch, lambda q, k, v, *_:
                          F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=False),
                          copies, iters)
    graphs = []
    for q, k, v, do, *_ in copies:
        ins = tuple(t.detach().requires_grad_() for t in (q, k, v))
        graphs.append((F.scaled_dot_product_attention(
            *ins, is_causal=False), ins, do))
    lib_bwd = runs_ms(torch, lambda o, ins, do: torch.autograd.grad(
        o, ins, do, retain_graph=True), graphs, iters)
    del graphs
    for key, ms, plain, lib in (("fwd", fwd, plain_fwd, lib_fwd),
                                ("dq", dq, plain_bwd, lib_bwd),
                                ("dkv", dkv, plain_bwd, lib_bwd)):
        flops, nbytes = bounds[key]
        rows[key] = dict(ms=ms[0], ms_range=[ms[1], ms[2]],
                         plain_ms=plain[0], library_ms=lib[0],
                         **_bound_row(flops, nbytes),
                         tflops=flops / ms[0] / 1e9)
        log(f"N1 timing[{gpu}] {key} bf16 non-causal [{B}, {H}, {S}, {hd}]: "
            f"kernel {_spread(ms)} ms (CUDA graph) = "
            f"{rows[key]['tflops']:.1f} TFLOP/s, plain {_spread(plain)} ms"
            f"{' (whole backward)' if key != 'fwd' else ''}, library "
            f"(F.scaled_dot_product_attention{' backward' if key != 'fwd' else ''}"
            f", is_causal=False) {_spread(lib)} ms, bound "
            f"{rows[key]['bound_ms']:.4f} ms by {rows[key]['bound_by']} "
            f"({flops:.4g} flops, {nbytes} bytes)")
    rows["fwd"]["eager_ms"] = fwd_eager[0]
    rows["bwd_eager_ms"] = bwd_eager[0]
    log(f"N1 timing[{gpu}]: eager forward call {_spread(fwd_eager)} ms, the "
        f"port's eager backward call (delta + dq + dk/dv) "
        f"{_spread(bwd_eager)} ms")
    del copies
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_abs_err": errs, "tolerance_share": ratios,
            "float32": {"shape": list(NN_F32_CASE), "fwd": f32_fwd,
                        "bwd": f32_bwd}, "timing": rows}


def _long_doc_encoder(torch):
    """Embedding(32768, 512), TransformerEncoder(TransformerEncoderLayer(
    512, 8, 2048, dropout=0.1, attn_dropout=0.0), 6), Linear(512, 32768)
    with seeded random weights (drawn on the CPU), float32; its loss is
    cross-entropy over float32 logits."""
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.nn as nn

    class LongDocEncoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(NN_V, NN_D)
            self.encoder = nn.TransformerEncoder(nn.TransformerEncoderLayer(
                NN_D, NN_HEADS, NN_FF, dropout=0.1, attn_dropout=0.0),
                NN_LAYERS)
            self.head = nn.Linear(NN_D, NN_V)

        def forward(self, ids):
            return self.head(self.encoder(self.embedding(ids)))

        def loss(self, logits, labels):
            return nn.functional.cross_entropy(logits.float(), labels)

    ptt.seed(SEED + 71)
    return LongDocEncoder().to(DEVICE)


def _nn_batch(seed=SEED + 72):
    import numpy as np

    ids = np.random.RandomState(seed).randint(
        0, NN_V, size=(NN_B, NN_S)).astype(np.int64)
    return ids, ids.copy()  # labels: the tokens themselves (learnable)


def _flash_counters():
    from paddle_tpu_torch.ops import flash_attention
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq)
    return (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)


def nn_encoder_train(torch, gpu):
    """Phase N2: the long-document encoder through Model.train_batch under
    amp O1 (prepare(amp_configs="O1"): MultiHeadAttention and the Linears
    in bf16, the LayerNorms in float32; float32 parameters) with AdamW,
    NN_WARMUP + NN_STEPS steps of one seeded batch; losses finite and
    falling; kernels 4, 5 and 6 each launched once a layer a step."""
    import paddle_tpu_torch as ptt

    net = _long_doc_encoder(torch)
    opt = ptt.optimizer.AdamW(learning_rate=NN_LR, weight_decay=0.01)
    model = ptt.Model(net).prepare(optimizer=opt, loss=net.loss,
                                   amp_configs="O1")
    ids, labels = _nn_batch()
    torch.cuda.reset_peak_memory_stats()
    losses, wall, (fa, dq, dkv) = train_steps(
        torch, model, [ids], [labels], NN_WARMUP, NN_STEPS,
        _flash_counters())
    peak = torch.cuda.max_memory_allocated()
    want = NN_LAYERS * NN_STEPS
    log(f"N2 encoder (Transformer-base encoder, {NN_LAYERS} layers, "
        f"{NN_B}x{NN_S} tokens, vocab {NN_V}) under amp O1, AdamW({NN_LR}): "
        f"losses {[round(x, 4) for x in losses]}; launches over {NN_STEPS} "
        f"steps: flash_attention {fa}, flash_attention_bwd_dq {dq}, "
        f"flash_attention_bwd_dkv {dkv} (each = {want}: "
        f"{fa == dq == dkv == want})")
    assert fa == dq == dkv == want, (fa, dq, dkv, want)
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    tok = NN_B * NN_S
    step_ms = wall / NN_STEPS * 1e3
    log(f"N2 encoder[{gpu}]: {step_ms:.1f} ms/step, "
        f"{tok * NN_STEPS / wall:.0f} tokens/s, peak device memory "
        f"{peak / 2**20:.0f} MiB")
    del model, opt, net
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {"flash_attention": fa,
                         "flash_attention_bwd_dq": dq,
                         "flash_attention_bwd_dkv": dkv},
            "step_ms": step_ms, "tokens_per_s": tok * NN_STEPS / wall,
            "peak_bytes": peak, "losses": losses}


def _grad_step(torch, net, ids, labels, seed):
    """One forward + backward under amp O1 from ``seed``: (loss, {name:
    grad}, peak bytes, launches of kernels 4, 5, 6)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.amp import auto_cast

    counters = _flash_counters()
    for c in counters:
        c.launches = 0
    params = [p for p in net.parameters() if p.requires_grad]
    names = [n for n, p in net.named_parameters() if p.requires_grad]
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net.train()
    ptt.seed(seed)
    with auto_cast(level="O1"):
        loss = net.loss(net(ids), labels)
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = [c.launches for c in counters]
    return loss.detach(), dict(zip(names, grads)), peak, launches


def nn_encoder_recompute(torch, gpu, n2):
    """Phase N3: the N2 model from the same seed, dropout 0.1 active,
    under ``torch.use_deterministic_algorithms(True)``: one step without
    recompute, then with ``apply_recompute(net,
    ["TransformerEncoderLayer"])``, from the same parameters and generator
    seed — loss and every gradient bit-equal, kernel 4 launched twice a
    layer (forward and recomputation), kernels 5 and 6 once, peak memory
    below the step without; then three executions of
    ``fit(steps_per_execution=2)`` (a CUDA graph replayed from the second)
    against six eager ``fit`` steps: parameters bit-equal."""
    import numpy as np

    import paddle_tpu_torch as ptt

    ids_np, labels_np = _nn_batch()
    ids = torch.as_tensor(ids_np, device=DEVICE)
    labels = torch.as_tensor(labels_np, device=DEVICE)
    out = {}
    with _deterministic_algorithms(torch):
        net = _long_doc_encoder(torch)
        l0, g0, peak0, k0 = _grad_step(torch, net, ids, labels, SEED + 73)
        wrapped = ptt.nn.apply_recompute(net, ["TransformerEncoderLayer"])
        l1, g1, peak1, k1 = _grad_step(torch, net, ids, labels, SEED + 73)
        diff = {n: float((g0[n].double() - g1[n].double()).abs().max())
                for n in g0 if not torch.equal(g0[n], g1[n])}
        log(f"N3 recompute ({wrapped} TransformerEncoderLayers marked): "
            f"loss {float(l0):.6f} / {float(l1):.6f} (bit-equal: "
            f"{torch.equal(l0, l1)}), {len(g0) - len(diff)} of {len(g0)} "
            f"gradients bit-equal"
            + (f"; largest differences {sorted(diff.items(), key=lambda kv: -kv[1])[:4]}"
               if diff else ""))
        assert torch.equal(l0, l1) and not diff, (float(l0), float(l1), diff)
        want = [2 * NN_LAYERS, NN_LAYERS, NN_LAYERS]
        log(f"N3 launches a step: without recompute {k0}, with {k1} "
            f"(= {want}: {k1 == want}); peak device memory "
            f"{peak0 / 2**20:.0f} MiB without, {peak1 / 2**20:.0f} MiB with "
            f"({peak1 / peak0:.3f}x; N2's train_batch step "
            f"{n2['peak_bytes'] / 2**20:.0f} MiB)")
        assert k0 == [NN_LAYERS] * 3 and k1 == want, (k0, k1)
        assert peak1 < peak0, (peak1, peak0)
        out.update(loss=float(l0), launches_without=k0, launches_with=k1,
                   peak_without_bytes=peak0, peak_with_bytes=peak1)
        del net, g0, g1
        gc.collect()
        torch.cuda.empty_cache()

        rng = np.random.RandomState(SEED + 74)
        rows = 6 * NN_B  # six steps: three executions of two
        data = [rng.randint(0, NN_V, size=(rows, NN_S)).astype(np.int64)]
        data.append(data[0].copy())
        runs = {}
        for spe in (1, 2):
            net = _long_doc_encoder(torch)
            ptt.nn.apply_recompute(net, ["TransformerEncoderLayer"])
            model = ptt.Model(net, inputs=1, labels=1)
            model.prepare(optimizer=ptt.optimizer.AdamW(
                learning_rate=NN_LR, weight_decay=0.01), loss=net.loss,
                amp_configs="O1", steps_per_execution=spe)
            counters = _flash_counters()
            for c in counters:
                c.launches = 0
            ptt.seed(SEED + 75)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            model.fit(ptt.io.TensorDataset(data), batch_size=NN_B, epochs=1,
                      shuffle=False, verbose=0)
            torch.cuda.synchronize()
            runs[spe] = dict(
                wall=time.monotonic() - t0,
                params={k: p.detach().clone()
                        for k, p in net.named_parameters()},
                launches=[c.launches for c in counters],
                graph=model._graph_steps)
            del model, net
            gc.collect()
            torch.cuda.empty_cache()
        e, g = runs[1], runs[2]
        unequal = {k: float((e["params"][k].double()
                             - g["params"][k].double()).abs().max())
                   for k in e["params"]
                   if not torch.equal(e["params"][k], g["params"][k])}
        gs = g["graph"]
        log(f"N3 fit(steps_per_execution=2) with recompute: "
            f"{gs.executions} executions, {gs.captures} capture(s); "
            f"parameters after 6 steps: {len(e['params']) - len(unequal)} of "
            f"{len(e['params'])} bit-equal to 6 eager fit steps"
            + (f"; largest differences {sorted(unequal.items(), key=lambda kv: -kv[1])[:4]}"
               if unequal else "")
            + f"; launches (forward, dq, dk/dv): graph {g['launches']}, "
            f"eager {e['launches']}")
        assert gs.executions == 3 and gs.captures == 1, (gs.executions,
                                                         gs.captures)
        assert not unequal, unequal
        assert g["launches"] == e["launches"] == [
            12 * NN_LAYERS, 6 * NN_LAYERS, 6 * NN_LAYERS], (g["launches"],
                                                           e["launches"])
        out.update(graph_launches=g["launches"],
                   graph_params_bit_equal=True)
    return out


def _copy_task_transformer(torch):
    """nn.Transformer() at its defaults with token and learned position
    embeddings for source and target and an output Linear to the
    vocabulary."""
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.nn as nn

    class CopyTransformer(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_embedding = nn.Embedding(TR_V, 512)
            self.tgt_embedding = nn.Embedding(TR_V, 512)
            self.position = nn.Embedding(TR_S + 1, 512)
            self.transformer = nn.Transformer()
            self.head = nn.Linear(512, TR_V)

        def embed(self, table, ids, start=0):
            pos = torch.arange(start, start + ids.shape[1], device=ids.device)
            return table(ids) * 0.05 + self.position(pos) * 0.05

        def forward(self, src, tgt_in, src_mask, tgt_mask, memory_mask):
            out = self.transformer(self.embed(self.src_embedding, src),
                                   self.embed(self.tgt_embedding, tgt_in),
                                   src_mask=src_mask, tgt_mask=tgt_mask,
                                   memory_mask=memory_mask)
            return self.head(out)

        def loss(self, logits, labels):
            return nn.functional.cross_entropy(logits, labels)

    ptt.seed(SEED + 76)
    return CopyTransformer().to(DEVICE)


def nn_transformer_copy(torch, gpu):
    """Phase N4: nn.Transformer() (512, 8 heads, 6 + 6 layers, 2048,
    dropout 0.1) on a synthetic copy task, vocab 32768, batch 64 x 64
    source and 64 target tokens, ragged key-padding masks (bool) and
    generate_square_subsequent_mask, through Model.train_batch: the loss
    falls and the flash counters stay 0 (the masks keep the dense route,
    as the gate says); then a greedy decode of TR_DECODE tokens through
    the TransformerDecoderLayer caches, held to the uncached causal
    forward's argmax at every position (a mismatch only at a near-tie)."""
    import numpy as np

    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.nn as nn

    net = _copy_task_transformer(torch)
    rng = np.random.RandomState(SEED + 77)
    src = rng.randint(2, TR_V, size=(TR_B, TR_S)).astype(np.int64)
    lens = rng.randint(TR_S // 2, TR_S + 1, size=TR_B)
    keep = np.arange(TR_S)[None, :] < lens[:, None]
    src = np.where(keep, src, 0)
    tgt_in = np.concatenate([np.ones((TR_B, 1), np.int64), src[:, :-1]], 1)
    key_pad = keep[:, None, None, :]
    src_mask = np.broadcast_to(key_pad, (TR_B, 1, TR_S, TR_S)).copy()
    memory_mask = src_mask.copy()
    tgt_mask = nn.Transformer.generate_square_subsequent_mask(TR_S).numpy()
    model = ptt.Model(net, inputs=["src", "tgt_in", "src_mask", "tgt_mask",
                                   "memory_mask"], labels=["label"]).prepare(
        optimizer=ptt.optimizer.AdamW(learning_rate=1e-4), loss=net.loss)
    counters = _flash_counters()
    for c in counters:
        c.launches = 0
    inputs = [src, tgt_in, src_mask, tgt_mask, memory_mask]
    losses = [model.train_batch(inputs, [src])[0] for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    losses += [model.train_batch(inputs, [src])[0]
               for _ in range(TR_STEPS - 2)]
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) / (TR_STEPS - 2) * 1e3
    launches = [c.launches for c in counters]
    log(f"N4 nn.Transformer() copy task (vocab {TR_V}, {TR_B}x{TR_S}, "
        f"ragged source lengths {int(lens.min())}-{int(lens.max())}): "
        f"losses {[round(x, 4) for x in losses]}; {step_ms:.1f} ms/step; "
        f"flash launches {launches} (0: the masks keep the dense route)")
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    assert launches == [0, 0, 0], launches

    net.eval()
    tr = net.transformer
    with torch.no_grad():
        s = torch.as_tensor(src, device=DEVICE)
        mm = torch.as_tensor(memory_mask, device=DEVICE)
        memory = tr.encoder(net.embed(net.src_embedding, s),
                            src_mask=torch.as_tensor(src_mask,
                                                     device=DEVICE))
        cache = tr.decoder.gen_cache(memory)
        tok = torch.ones(TR_B, 1, dtype=torch.int64, device=DEVICE)
        seq = [tok]
        for t in range(TR_DECODE):
            x = net.embed(net.tgt_embedding, tok, start=t)
            y, cache = tr.decoder(x, memory, memory_mask=mm[:, :, :1],
                                  cache=cache)
            tok = net.head(y).argmax(-1)
            seq.append(tok)
        cached = torch.cat(seq, 1)                     # [B, 1 + TR_DECODE]
        full = tr.decoder(net.embed(net.tgt_embedding, cached[:, :-1]),
                          memory, tgt_mask=nn.Transformer
                          .generate_square_subsequent_mask(TR_DECODE),
                          memory_mask=mm[:, :, :TR_DECODE])
        logits = net.head(full)
        top2 = logits.topk(2, -1).values
        want = logits.argmax(-1)
        miss = want != cached[:, 1:]
        gaps = (top2[..., 0] - top2[..., 1])[miss]
        scale = float(logits.abs().max())
    n_miss = int(miss.sum())
    log(f"N4 greedy decode of {TR_DECODE} tokens through the decoder "
        f"caches: {miss.numel() - n_miss} of {miss.numel()} tokens equal "
        f"to the uncached causal forward's argmax"
        + (f"; the others at near-ties (top-2 gaps {gaps.tolist()} of "
           f"max |logit| {scale:.3f})" if n_miss else ""))
    assert n_miss == 0 or bool((gaps <= 1e-5 * scale).all()), gaps
    del model, net
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms,
            "decode_tokens_equal": miss.numel() - n_miss,
            "decode_tokens": miss.numel(), "flash_launches": launches}


def _lm_stream(n, seed):
    """A seeded synthetic token stream with structure to learn: each token
    is one of four successors of the previous one, the successors drawn
    Zipf-distributed over the vocabulary (a skewed unigram, as text's)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    succ = (rng.zipf(1.3, size=(LM_V, 4)) - 1) % LM_V
    out = np.empty(n, np.int64)
    out[0] = 0
    choice = rng.randint(0, 4, size=n)
    for i in range(1, n):
        out[i] = succ[out[i - 1], choice[i]]
    return out


def nn_lstm_lm(torch, gpu):
    """Phase N5: the medium LSTM language model of Zaremba et al. 2014 (2 x
    650, vocab 10000, 35 steps, batch 20, dropout 0.5) with SGD(1.0,
    grad_clip=ClipGradByGlobalNorm(5.0)) over a seeded synthetic stream:
    LM_STEPS train_batch steps, the loss falls, the step time; then a
    bidirectional 2-layer LSTM and a GRU with ragged sequence_length on
    the card and on the CPU from the same weights (float32, TF32 off): the
    largest differences printed and held at 1e-4."""
    import numpy as np

    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.nn as nn

    class LSTMLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(LM_V, LM_H)
            self.dropout = nn.Dropout(0.5)
            self.lstm = nn.LSTM(LM_H, LM_H, num_layers=LM_LAYERS,
                                dropout=0.5)
            self.head = nn.Linear(LM_H, LM_V)

        def forward(self, ids):
            out, _ = self.lstm(self.dropout(self.embedding(ids)))
            return self.head(self.dropout(out))

        def loss(self, logits, labels):
            return nn.functional.cross_entropy(logits, labels)

    ptt.seed(SEED + 78)
    net = LSTMLM().to(DEVICE)
    opt = ptt.optimizer.SGD(learning_rate=1.0,
                            grad_clip=nn.ClipGradByGlobalNorm(5.0))
    model = ptt.Model(net).prepare(optimizer=opt, loss=net.loss)
    stream = _lm_stream(LM_B * (LM_T + 1) * LM_STEPS, SEED + 79).reshape(
        LM_STEPS, LM_B, LM_T + 1)
    losses = [model.train_batch([stream[0, :, :-1]], [stream[0, :, 1:]])[0]]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for i in range(1, LM_STEPS):
        losses.append(model.train_batch([stream[i, :, :-1]],
                                        [stream[i, :, 1:]])[0])
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) / (LM_STEPS - 1) * 1e3
    log(f"N5 LSTM LM (Zaremba medium: {LM_LAYERS}x{LM_H}, vocab {LM_V}, "
        f"{LM_T} steps, batch {LM_B}, dropout 0.5, SGD(1.0) + global-norm "
        f"clip 5): losses {[round(x, 4) for x in losses]}; {step_ms:.1f} "
        f"ms/step ({LM_B * LM_T / step_ms * 1e3:.0f} tokens/s)")
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], (losses[0], losses[-1])

    diffs = {}
    x = np.random.RandomState(SEED + 80).randn(6, 24, 96).astype(np.float32)
    lens = np.array([24, 17, 9, 1, 24, 12], np.int64)
    for name, make in (("bilstm", lambda: nn.LSTM(
            96, 128, num_layers=2, direction="bidirect")),
            ("gru", lambda: nn.GRU(96, 128, num_layers=2))):
        ptt.seed(SEED + 81)
        cpu = make()
        card = make().to(DEVICE)
        card.load_state_dict(cpu.state_dict())
        with torch.no_grad():
            oc, sc = cpu(torch.tensor(x), sequence_length=torch.tensor(lens))
            og, sg = card(torch.tensor(x, device=DEVICE),
                          sequence_length=torch.tensor(lens, device=DEVICE))
        leaves = [(oc, og)] + (list(zip(sc, sg)) if isinstance(sc, tuple)
                               else [(sc, sg)])
        diffs[name] = max(float((a - b.cpu()).abs().max()) for a, b in leaves)
        assert bool((og[3, 1:] == 0).all())  # past length 1: zeros
    log(f"N5 card vs CPU from the same weights (ragged lengths "
        f"{lens.tolist()}): largest |difference| {diffs} (<= 1e-4)")
    assert max(diffs.values()) <= 1e-4, diffs
    del model, opt, net
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms,
            "tokens_per_s": LM_B * LM_T / step_ms * 1e3,
            "card_vs_cpu_max_abs": diffs}


def _seq2seq(torch, nn, V, H):
    class Seq2Seq(nn.Layer):
        """The JAX test's GRU encoder-decoder (tests/test_decode.py)."""

        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(V, H)
            self.enc = nn.GRU(H, H)
            self.cell = nn.GRUCell(H, H)
            self.out = nn.Linear(H, V)

        def encode(self, s):
            _, h = self.enc(self.emb(s))
            return h[0]

        def forward(self, s, t_in):
            h = self.encode(s)
            xs = self.emb(t_in)
            outs = []
            for t in range(xs.shape[1]):
                o, h = self.cell(xs[:, t], h)
                outs.append(o)
            return self.out(torch.stack(outs, 1))

        def loss(self, logits, labels):
            return nn.functional.cross_entropy(logits, labels)

    return Seq2Seq()


def _beam_decode(torch, net, src, beam, max_steps, raw=False):
    """BeamSearchDecoder + dynamic_decode over ``net``'s cell from its
    encoding of ``src``; ``raw``: the per-step outputs (scores, ids,
    parents) without the backtrace."""
    import paddle_tpu_torch.nn as nn

    dec = nn.BeamSearchDecoder(net.cell, start_token=0, end_token=1,
                               beam_size=beam, embedding_fn=net.emb,
                               output_fn=net.out)
    if raw:
        def finalize(outputs, states, lengths):
            raise NotImplementedError
        dec.finalize = finalize
    with torch.no_grad():
        return nn.dynamic_decode(dec, inits=net.encode(src),
                                 max_step_num=max_steps, return_length=True)


def nn_beam_search(torch, gpu):
    """Phase N6: the JAX test's GRU seq2seq (tests/test_decode.py) trained
    on its copy task on the card (V 12, H 32, 64 sequences of 5, Adam
    0.02, S2S_STEPS steps), then beam 3 decodes it (top-beam accuracy >
    0.9); then the same structure at H 512, vocab 32768, batch 64 from
    seeded weights (output weights x BEAM_SHARPEN, so the top-k gaps stand
    far above float32 rounding): BeamSearchDecoder(beam_size=4) +
    dynamic_decode(max_step_num=32) on the card and on the CPU — ids,
    parents and lengths equal, scores within 1e-5 relative, the same
    number of steps."""
    import numpy as np

    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.nn as nn

    rng = np.random.RandomState(SEED + 82)
    src = rng.randint(2, S2S_V, size=(S2S_N, S2S_T)).astype(np.int64)
    t_in = np.concatenate([np.zeros((S2S_N, 1), np.int64), src[:, :-1]], 1)
    ptt.seed(SEED + 83)
    net = _seq2seq(torch, nn, S2S_V, S2S_H).to(DEVICE)
    model = ptt.Model(net, inputs=["src", "t_in"], labels=["label"]).prepare(
        optimizer=ptt.optimizer.Adam(learning_rate=0.02), loss=net.loss)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    losses = [model.train_batch([src, t_in], [src])[0]
              for _ in range(S2S_STEPS)]
    torch.cuda.synchronize()
    train_s = time.monotonic() - t0
    net.eval()
    ids, _, lens = _beam_decode(torch, net, torch.as_tensor(
        src[:8], device=DEVICE), 3, S2S_T - 1)
    top = ids[:, :, 0].cpu().numpy()
    acc = float((top[:, :S2S_T] == src[:8, :top.shape[1]]).mean())
    log(f"N6 GRU seq2seq copy task on the card (V {S2S_V}, H {S2S_H}, "
        f"{S2S_STEPS} Adam steps in {train_s:.2f}s): loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; beam 3 top-beam accuracy {acc:.3f} (> 0.9)")
    assert acc > 0.9, acc
    del model, net

    ptt.seed(SEED + 84)
    cpu = _seq2seq(torch, nn, BEAM_V, BEAM_H)
    with torch.no_grad():
        cpu.out.weight.mul_(BEAM_SHARPEN)
    card = _seq2seq(torch, nn, BEAM_V, BEAM_H).to(DEVICE)
    card.load_state_dict(cpu.state_dict())
    cpu.eval()
    card.eval()
    src = np.random.RandomState(SEED + 85).randint(
        2, BEAM_V, size=(BEAM_B, 12)).astype(np.int64)
    res = {}
    for name, net, dev in (("cpu", cpu, "cpu"), ("card", card, DEVICE)):
        s = torch.as_tensor(src, device=dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ids, states, lens = _beam_decode(torch, net, s, BEAM_K, BEAM_MAX)
        raw, _, _ = _beam_decode(torch, net, s, BEAM_K, BEAM_MAX, raw=True)
        torch.cuda.synchronize()
        res[name] = dict(ids=ids.cpu(), lens=lens.cpu(),
                         lengths=states.lengths.cpu(),
                         scores=raw.scores.cpu(),
                         step_ids=raw.predicted_ids.cpu(),
                         parents=raw.parent_ids.cpu(),
                         seconds=(time.monotonic() - t0) / 2)
    c, g = res["cpu"], res["card"]
    same = {k: torch.equal(c[k], g[k])
            for k in ("ids", "lens", "lengths", "step_ids", "parents")}
    score_rel = float(((c["scores"].double() - g["scores"].double()).abs()
                       / c["scores"].double().abs().clamp_min(1.0)).max())
    steps = int(g["parents"].shape[1])
    finished_rows = int((g["lens"] < steps).all(-1).sum())
    log(f"N6 beam search at H {BEAM_H}, vocab {BEAM_V}, batch {BEAM_B}, "
        f"beam {BEAM_K}, max_step_num {BEAM_MAX}: {steps} steps on both "
        f"({c['parents'].shape[1]} on the CPU); card vs CPU equal: {same}; "
        f"scores' largest relative difference {score_rel:.2e}; "
        f"{finished_rows} of {BEAM_B} rows finished every beam early; "
        f"decode {g['seconds'] * 1e3:.1f} ms on the card, "
        f"{c['seconds'] * 1e3:.1f} ms on the CPU")
    assert all(same.values()) and score_rel <= 1e-5, (same, score_rel)
    assert c["parents"].shape == g["parents"].shape
    del cpu, card
    gc.collect()
    torch.cuda.empty_cache()
    return {"copy_task_accuracy": acc, "copy_task_losses": [losses[0],
                                                            losses[-1]],
            "beam_steps": steps, "card_equals_cpu": same,
            "score_max_rel_diff": score_rel,
            "decode_ms": {"card": g["seconds"] * 1e3,
                          "cpu": c["seconds"] * 1e3}}


def nn_phases(torch, gpu):
    """Phases N1-N6 and the ``{"nn": ...}`` line (N7); returns what the
    kernels line needs."""
    n1 = nn_flash_noncausal(torch, gpu)
    n2 = nn_encoder_train(torch, gpu)
    n3 = nn_encoder_recompute(torch, gpu, n2)
    n4 = nn_transformer_copy(torch, gpu)
    n5 = nn_lstm_lm(torch, gpu)
    n6 = nn_beam_search(torch, gpu)
    log(json.dumps({"nn": {
        "device": gpu,
        "N1_noncausal_flash": n1,
        "N2_long_document_encoder": {k: v for k, v in n2.items()},
        "N3_recompute": n3, "N4_transformer_copy": n4,
        "N5_lstm_lm": n5, "N6_beam_search": n6}}))
    return {"N1": n1, "N2": n2, "N3": n3}


# -- MoE and quantization wherever the JAX package runs them (E1-E5, C1-C3)
E_QTOL = {"int8": 0.1, "fp8": 0.25}  # logits x max|logit| (E3, E5)
E_TIGHT_CF = 1.25                    # E2: GPTConfig's default factor
BERT_MOE_B, BERT_MOE_S = 64, 128     # E4: config 3 cut to 64 x 128
BERT_MOE_WARMUP, BERT_MOE_STEPS = 2, 5
QBERT_B, QBERT_PARITY_B = 32, 2      # E5: the batch, card vs CPU
QBERT_RUNS = 3
C1_SHAPES = (                        # (name, M, K, N) of kernel 9's new uses
    ("bert qkv", 4096, 768, 2304), ("bert out", 4096, 768, 768),
    ("bert fc1", 4096, 768, 3072), ("bert fc2", 4096, 3072, 768),
    ("resnet50 stem 7x7/2", 128 * 112 * 112, 147, 64),
    ("resnet50 layer1 3x3", 128 * 56 * 56, 576, 64),
    ("resnet50 layer2 3x3", 128 * 28 * 28, 1152, 128),
    ("resnet50 layer3 3x3", 128 * 14 * 14, 2304, 256),
    ("resnet50 layer4 3x3", 128 * 7 * 7, 4608, 512),
    ("mobilenet_v2 stem 3x3/2", 64 * 112 * 112, 27, 32),
    ("mobilenet_v2 expand 16-96", 64 * 112 * 112, 16, 96),
    ("mobilenet_v2 project 96-24", 64 * 56 * 56, 96, 24),
    ("mobilenet_v2 expand 160-960", 64 * 7 * 7, 160, 960),
    ("mobilenet_v2 last 320-1280", 64 * 7 * 7, 320, 1280),
    ("mobilenet_v2 classifier", 64, 1280, 1000))
C2_B, C2_HW, C2_CALIB, C2_RUNS = 128, 224, 4, 3
C2_REL_L2 = 0.1        # int8 vs float logits (0.0228 read on an H100)
C2_CPU = dict(B=2, HW=128)
C2_CPU_REL_L2 = 0.1    # card vs CPU, the same int8 model (layers exact)
C3_B, C3_HW, C3_WARMUP, C3_STEPS, C3_RUNS = 64, 224, 2, 5, 3
C3_REL_L2 = 0.35       # int8 vs the fake-quant eval (0.1162 on an H100)
C3_CPU_B = 2
C3_CPU_REL_L2 = 0.1    # card vs CPU, the same int8 model (layers exact)


@contextlib.contextmanager
def moe_routes(replay=None):
    """Record every MoE layer's routing (``MoELayer._route``'s outputs:
    probabilities, combine weights, experts, slots, kept) in call order;
    with ``replay`` (such a record), return its entries in order instead
    of routing, so a forward takes another forward's decisions."""
    from paddle_tpu_torch.moe import layer as moe_layer

    seen = []
    route = moe_layer.MoELayer._route

    def rec(self, xf, C):
        out = (route(self, xf, C) if replay is None
               else replay[len(seen)])
        seen.append(out)
        return out

    moe_layer.MoELayer._route = rec
    try:
        yield seen
    finally:
        moe_layer.MoELayer._route = route


def moe_quant_logits(torch, model, mode, hists, tag):
    """E3's logit gate.  The quantized copy and the float model are
    teacher-forced over each served history.  With the quantized copy
    routed by the float model's decisions (``moe_routes(replay=...)``),
    its logits must stay within ``E_QTOL[mode]`` x max|logit| of the float
    model's at every row (tests/test_torch_quantized_serving.py's rule).
    Routed freely, quantization flips some routing decisions, and a row
    whose experts changed (or that attends to one) moves by another
    expert's FFN: those errors are printed, not gated (on an H100 the
    free rows with a flip reached 0.44-0.54 x max|logit|, the rows under
    the float routing 0.03-0.10)."""
    from paddle_tpu_torch import slim

    qmodel = slim.quantize_model(model, mode)
    forced = free = 0.0
    rows = flipped = 0
    with torch.no_grad():
        for h in hists:
            ids = torch.tensor([h], device=model.device)
            with moe_routes() as rf:
                lf = model(ids)[0]
            with moe_routes(replay=rf):
                lq = qmodel(ids)[0]
            with moe_routes() as rq:
                lq_free = qmodel(ids)[0]
            top = max(float(lf.abs().max()), 1e-30)
            forced = max(forced, float((lq - lf).abs().max()) / top)
            free = max(free, float((lq_free - lf).abs().max()) / top)
            ef = torch.stack([r[2].sort(-1).values for r in rf])
            eq = torch.stack([r[2].sort(-1).values for r in rq])
            flipped += int((ef != eq).any(-1).any(0).sum())
            rows += lf.shape[0]
    del qmodel
    log(f"{tag}: teacher-forced logits of the {mode} copy vs the float "
        f"model over {len(hists)} served histories ({rows} rows): routed "
        f"by the float model's decisions, largest error {forced:.4f} x "
        f"max|logit| (< {E_QTOL[mode]}: {forced < E_QTOL[mode]}); routed "
        f"freely, {flipped} rows with a flipped routing decision, largest "
        f"error {free:.4f} x max|logit| (not gated)")
    assert forced < E_QTOL[mode], (mode, forced)
    return {"rows": rows, "max_err_float_routing": forced,
            "max_err_free_routing": free, "rows_flipped": flipped,
            "tolerance": E_QTOL[mode]}


@contextlib.contextmanager
def compression_shapes():
    """Record what the slice's paths hand kernels 9 and 10: (M, K, N,
    codes dtype) at slim's ``quantized_product`` (the int8 layers) and
    (x shape, w shape, dtype, group sizes) at the MoE layer's
    ``grouped_matmul``.  Pass-throughs: nothing is launched or counted
    here."""
    from paddle_tpu_torch.moe import layer as moe_layer
    from paddle_tpu_torch.slim import quantization as sq

    seen = {"qp": set(), "gmm": {}}
    qp, gmm = sq.quantized_product, moe_layer.grouped_matmul

    def rec_qp(xq, wq, scale, bias):
        seen["qp"].add((xq.shape[0], xq.shape[1], wq.shape[1], wq.dtype))
        return qp(xq, wq, scale, bias)

    def rec_gmm(x, w, gs, *a, **k):
        key = (tuple(x.shape), tuple(w.shape), x.dtype)
        if key not in seen["gmm"]:
            seen["gmm"][key] = gs.detach().clone()
        return gmm(x, w, gs, *a, **k)

    sq.quantized_product, moe_layer.grouped_matmul = rec_qp, rec_gmm
    try:
        yield seen
    finally:
        sq.quantized_product, moe_layer.grouped_matmul = qp, gmm


def qp_check(torch, M, K, N, gen):
    """Kernel 9 on caller-quantized int8 codes at one shape (the int8
    layers' route): random codes, scale and bias drawn on the card from
    ``gen`` (a card generator); bit-equal to the plain version, and two
    launches bit-equal."""
    from paddle_tpu_torch.ops.quantized_matmul import (_matmul_kernel,
                                                       _matmul_ref)

    xq = torch.randint(-127, 128, (M, K), generator=gen, dtype=torch.int8,
                       device=DEVICE)
    wq = torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8,
                       device=DEVICE)
    scale = torch.rand(N, generator=gen, device=DEVICE) * 1e-3
    bias = torch.randn(N, generator=gen, device=DEVICE)
    out = _matmul_kernel(xq, wq, scale, bias)
    out2 = _matmul_kernel(xq, wq, scale, bias)
    ref = _matmul_ref(xq, wq, scale, bias)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and torch.equal(out, out2), \
        f"kernel 9 differs from plain at [{M}, {K}] @ [{K}, {N}]"
    del xq, wq, out, out2, ref


def gmm_path_check(torch, gmm, x, w, gs, dtype_name, shape):
    """Kernel 10 at one shape a path gave it, with that path's group sizes:
    ``gmm_check``'s gates (two launches bit-equal, padding rows exactly 0,
    ``GMM_TOL``), its rms taken over the valid rows: the paths' groups are
    often far below C, and zero padding rows would shrink the rms.
    Returns (max abs error, the largest share of the tolerance used)."""
    C = x.shape[1]
    valid = (torch.arange(C, device=DEVICE)[None, :]
             < gs.clamp(0, C)[:, None])
    x = x.clone()
    x[~valid] = float("nan")
    y = gmm.grouped_matmul(x, w, gs)
    y2 = gmm.grouped_matmul(x, w, gs)
    ref = gmm.grouped_matmul_ref(x, w, gs)
    torch.cuda.synchronize()
    assert torch.equal(y, y2), f"two launches differ at {shape}"
    assert not bool(y[~valid].any()), f"padding rows not 0 at {shape}"
    if not bool(valid.any()):
        return 0.0, 0.0
    rel, floor = GMM_TOL[dtype_name]
    yf, rf = y.float()[valid], ref.float()[valid]
    err = (yf - rf).abs()
    allowed = rel * rf.abs() + floor * float(rf.pow(2).mean().sqrt())
    share = float((err / allowed.clamp_min(1e-30)).max())
    assert bool((err <= allowed).all()), (shape, float(err.max()), share)
    return float(err.max()), share


def layer_parity(torch, net, types, args, label, exact=True):
    """Every layer of ``net`` of ``types`` on the card against its copy on
    the CPU fed the very input the card's forward handed it (forward
    hooks): bit-equal for int8 (the activation codes come from IEEE
    divisions on both devices, kernel 9 equals its plain version bit for
    bit, the grouped route sums exact integers, the epilogue is one
    float32 multiply and one add on both); ``exact=False`` (fp8: float32
    sums in another order) within rtol 1e-4, atol 1e-4 x max|out|.
    Returns the number of layer calls held."""
    import copy

    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append((mod, inp[0].detach(),
                                           out.detach())))
        for _, m in net.named_sublayers() if isinstance(m, types)]
    try:
        with torch.no_grad():
            net(*args)
    finally:
        for h in hooks:
            h.remove()
    copies = {}
    for mod, inp, out in seen:
        cpu = copies.get(id(mod))
        if cpu is None:
            cpu = copies[id(mod)] = copy.deepcopy(mod).to("cpu")
        with torch.no_grad():
            want = cpu(inp.cpu())
        got = out.cpu()
        if exact:
            assert torch.equal(got, want), (label, type(mod).__name__,
                                            tuple(inp.shape))
        else:
            torch.testing.assert_close(
                got.float(), want.float(), rtol=1e-4,
                atol=1e-4 * float(want.float().abs().max()))
    log(f"{label}: {len(seen)} quantized layer calls on the card equal "
        f"their CPU copies' on the same inputs "
        f"({'bit for bit' if exact else 'rtol 1e-4, atol 1e-4 x max|out|'})")
    assert seen, label
    return len(seen)


def check_compression_shapes(torch, seen, label):
    """Kernels 9 and 10 against their plain versions at every shape a
    phase handed them (``compression_shapes``): kernel 9 bit-equal
    (``qp_check``), kernel 10 with the group sizes the path gave it
    (``gmm_check``, ``GMM_TOL``).  Returns what the kernels line keeps."""
    import importlib

    gmm = importlib.import_module("paddle_tpu_torch.ops.grouped_matmul")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 91)
    out = {}
    if seen["qp"]:
        shapes = sorted(seen["qp"], key=str)
        for M, K, N, dt in shapes:
            assert dt == torch.int8, dt
            qp_check(torch, M, K, N, gen)
        out["quantized_matmul"] = {
            "shapes": [f"[{M}, {K}] @ [{K}, {N}]" for M, K, N, _ in shapes],
            "max_abs_err": 0.0}
        log(f"{label}: kernel quantized_matmul bit-equal to plain (and two "
            f"launches bit-equal) at the {len(shapes)} shapes the int8 "
            f"layers gave it: {out['quantized_matmul']['shapes']}")
    if seen["gmm"]:
        worst, top, shapes = 0.0, 0.0, []
        for (xs, ws, dt), gs in sorted(seen["gmm"].items(), key=str):
            name = str(dt).replace("torch.", "")
            x = torch.randn(*xs, generator=gen, device=DEVICE).to(dt)
            w = (torch.randn(*ws, generator=gen, device=DEVICE)
                 / ws[1] ** 0.5).to(dt)
            err, share = gmm_path_check(torch, gmm, x, w, gs, name,
                                        f"{list(xs)} x {list(ws)}")
            worst, top = max(worst, err), max(top, share)
            shapes.append(f"{name} {list(xs)} x {list(ws)} gs="
                          f"{gs.tolist()}")
            del x, w
        log(f"{label}: kernel grouped_matmul at the {len(shapes)} shapes "
            f"the path gave it (with its group sizes; the dense forwards "
            f"the gates run included), e.g. {shapes[:2]} ... "
            f"{shapes[-1:]}: max_abs_err={worst:.3e}, {top:.3f} of "
            f"GMM_TOL at most, padding rows 0, two launches bit-equal; ok")
        out["grouped_matmul"] = {"shapes": len(shapes),
                                 "examples": shapes[:4],
                                 "max_abs_err": worst,
                                 "max_tolerance_share": top}
    return out


def moe_dense_engine(torch, gpu, model, tag, continuous=True,
                     quantized=None, greedy=True, d1_outs=None):
    """Phases E1 (``continuous`` and legacy), E2 and E3's dense half: an
    MoE model behind the default dense-ring engine or the legacy
    scheduler, over phase 4's requests.  Gates: every request completes,
    ``grouped_matmul`` 2 a layer a call (and ``quantized_matmul`` 2 a
    layer a call when quantized; never ``paged_flash_decode``), no routed
    count from the warm-up, ``moe_routed_tokens`` + ``moe_dropped_tokens``
    = layers x top_k x batch x decode steps (inert rows route too);
    ``greedy``: no dropped token and 4 requests' tokens against uncached
    greedy (near-ties only), or equal to ``d1_outs``."""
    from paddle_tpu_torch.ops import grouped_matmul
    from paddle_tpu_torch.ops.paged_attention import paged_flash_decode
    from paddle_tpu_torch.ops.quantized_matmul import quantized_linear
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = model.gpt.cfg
    L, k, Bn = cfg.num_layers, cfg.moe_top_k, 8
    reqs = requests()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    kw = {} if continuous else dict(continuous=False)
    with GenerationEngine(model, prompt_buckets=[16, 48], batch_size=Bn,
                          quantized=quantized, name=f"chip-smoke-{tag}",
                          **kw) as eng:
        t0 = time.monotonic()
        eng.warmup()
        st0 = eng.stats()
        assert not st0["paged"] and st0["continuous"] == continuous, st0
        assert st0["moe_routed_tokens"] == 0, "warm-up steps were counted"
        log(f"{tag}: warmup {time.monotonic() - t0:.2f}s (no routing count "
            f"from it)")
        grouped_matmul.launches = 0
        quantized_linear.launches = 0
        paged_flash_decode.launches = 0
        t0 = time.monotonic()
        outs = [f.result(600) for f in [eng.submit(p, n)
                                        for p, n, _ in reqs]]
        wall = time.monotonic() - t0
    # read after close: every dispatched step has launched and been folded
    st = eng.stats()
    peak = torch.cuda.max_memory_allocated()
    gm, qm = grouped_matmul.launches, quantized_linear.launches
    calls = ((st["batches"] - st0["batches"])
             + (st["decode_steps"] - st0["decode_steps"]))
    steps = st["decode_steps"] - st0["decode_steps"]
    routed, dropped = st["moe_routed_tokens"], st["moe_dropped_tokens"]
    want_q = 2 * L * calls if quantized else 0
    log(f"{tag}: {len(outs)} requests, {calls} MoE calls ({steps} decode "
        f"steps); grouped_matmul {gm} (= 2 x {L} x {calls}: "
        f"{gm == 2 * L * calls}), quantized_matmul {qm} (= {want_q}), "
        f"paged_flash_decode {paged_flash_decode.launches}; routed "
        f"{routed} + dropped {dropped} (= {L} x {k} x {Bn} x {steps}: "
        f"{routed + dropped == L * k * Bn * steps}), overflow fraction "
        f"{dropped / max(routed + dropped, 1):.4f}, dead experts "
        f"{st.get('moe_dead_experts')}")
    assert st["completed"] == NUM_REQUESTS and st["errors"] == 0, st
    assert gm == 2 * L * calls and qm == want_q, (gm, qm, calls)
    assert paged_flash_decode.launches == 0
    assert routed + dropped == L * k * Bn * steps, (routed, dropped, steps)
    assert st["moe_sampled_steps_after_warm"] == steps, st
    n_tok = 0
    for (p, n, _), out in zip(reqs, outs):
        assert out.shape == (n,) and out.min() >= 0 \
            and out.max() < cfg.vocab_size, (out.shape, n)
        n_tok += n
    r = {"tokens_per_s": n_tok / wall, "mean_ms": st["mean_ms"],
         "p99_ms": st["p99_ms"], "peak_bytes": peak, "decode_steps": steps,
         "moe_calls": calls, "grouped_matmul_launches": gm,
         "quantized_matmul_launches": qm, "moe_routed_tokens": routed,
         "moe_dropped_tokens": dropped,
         "overflow_frac": dropped / max(routed + dropped, 1),
         "dead_experts": st.get("moe_dead_experts")}
    if greedy:
        assert dropped == 0, dropped
        if d1_outs is None:
            compared = ties = 0
            for (p, _, _), out in list(zip(reqs, outs))[:4]:
                c, t = greedy_margin_check(torch, model, p, out.tolist(),
                                           cfg.vocab_size)
                compared += c
                ties += t
            assert compared >= 20, compared
            r["greedy_tokens_compared"] = compared
            log(f"{tag}: {compared} tokens of 4 requests agree with uncached "
                f"greedy on the card ({ties} near-tie divergences)")
        else:
            same = sum(a.tolist() == b.tolist()
                       for a, b in zip(outs, d1_outs))
            for (p, _, _), a, b in zip(reqs, outs, d1_outs):
                if a.tolist() != b.tolist():
                    greedy_margin_check(torch, model, p, a.tolist(),
                                        cfg.vocab_size)
            r["requests_equal_to_continuous"] = same
            log(f"{tag}: tokens equal the continuous engine's in {same} of "
                f"{NUM_REQUESTS} requests (the others a near-tie of greedy)")
    if quantized:
        r["logits_vs_float"] = moe_quant_logits(
            torch, model, quantized, [[int(t) for t in p]
                                      + out.tolist()[:-1]
                                      for (p, _, _), out in zip(reqs, outs)],
            tag)
    log(f"{tag}[{gpu}]: {n_tok} tokens in {wall:.3f}s = "
        f"{n_tok / wall:.1f} tokens/s, mean request latency "
        f"{st['mean_ms']:.1f} ms (p99 {st['p99_ms']:.1f} ms), peak device "
        f"memory {peak / 2**20:.0f} MiB")
    return r, outs


def moe_serving_phases(torch, gpu, d1, m4):
    """E1-E3: the MoE model of M4 (f32, capacity factor 8, jitter 0)
    behind the dense engines, then at the default factor 1.25 (E2), then
    quantized behind the paged and the dense engines (E3)."""
    with compression_shapes() as seen:
        model = moe_model(torch, "float32", moe_capacity_factor=MOE_SERVE_CF,
                          moe_jitter=0.0)
        model.eval()
        e1, e1_outs = moe_dense_engine(torch, gpu, model, "E1")
        e1l, _ = moe_dense_engine(torch, gpu, model, "E1[legacy]",
                                  continuous=False, d1_outs=e1_outs)
        for name, r in (("D1 float dense", d1), ("M4 MoE paged", m4),
                        ("E1 MoE dense", e1), ("E1 MoE legacy", e1l)):
            log(f"E1[{gpu}] beside: {name}: {r['tokens_per_s']:.1f} "
                f"tokens/s, mean latency {r['mean_ms']:.1f} ms, p99 "
                f"{r['p99_ms']:.1f} ms, peak {r['peak_bytes'] / 2**20:.0f} "
                f"MiB")
        e3 = {}
        for mode in QUANT_MODES:
            e3[f"paged_{mode}"] = serve(torch, gpu, model, quantized=mode)
            e3[f"dense_{mode}"], _ = moe_dense_engine(
                torch, gpu, model, f"E3[dense-{mode}]", quantized=mode,
                greedy=False)
        del model
        tight = moe_model(torch, "float32", moe_capacity_factor=E_TIGHT_CF,
                          moe_jitter=0.0)
        tight.eval()
        e2, _ = moe_dense_engine(torch, gpu, tight, "E2", greedy=False)
        del tight
    checked = check_compression_shapes(torch, seen, "E1-E3")
    gc.collect()
    torch.cuda.empty_cache()
    return {"E1": e1, "E1_legacy": e1l, "E2": e2, "E3": e3,
            "path_checks": checked}


def bert_moe_train(torch, gpu):
    """Phase E4: BERT-base MoE pretraining (every layer's MLP an 8-expert
    top-2 ``MoELayer``) in bf16 with AdamW(multi_precision) through
    ``Model.train_batch`` at 64 x 128, 20 masked."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import BertForPretraining, bert_base
    from paddle_tpu_torch.moe import stats
    from paddle_tpu_torch.ops import (grouped_matmul, layernorm_residual,
                                      softmax_cross_entropy)

    cfg = bert_base(moe_experts=MOE_E, moe_top_k=MOE_K)
    L = cfg.num_layers
    t0 = time.monotonic()
    ptt.seed(SEED)
    net = BertForPretraining(cfg, device=DEVICE).astype("bfloat16")
    assert net.bert.layers[0].mlp.expert_fc1.dtype == torch.bfloat16
    opt = ptt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                              multi_precision=True)
    model = ptt.Model(net, ["input_ids", "token_type_ids", "attention_mask",
                            "masked_positions"],
                      ["mlm_labels", "nsp_labels"]).prepare(
        optimizer=opt, loss=net.loss)
    inputs, labels = bert_batch(cfg.vocab_size, BERT_MOE_B, BERT_MOE_S,
                                BERT_P, seed=SEED + 93)
    n_all = sum(p.numel() for p in net.parameters())
    log(f"E4: bert_base(moe_experts={MOE_E}, moe_top_k={MOE_K}) bf16, "
        f"{n_all} parameters, capacity factor {cfg.moe_capacity_factor}, "
        f"jitter {cfg.moe_jitter}; batch {BERT_MOE_B}x{BERT_MOE_S}, "
        f"{BERT_P} masked; built in {time.monotonic() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with compression_shapes() as seen:
        losses, wall, (gm, ln, sx) = train_steps(
            torch, model, inputs, labels, BERT_MOE_WARMUP, BERT_MOE_STEPS,
            (grouped_matmul, layernorm_residual, softmax_cross_entropy))
        peak = torch.cuda.max_memory_allocated()
        net.train()  # the routing after the last step (train mode, jitter)
        with torch.no_grad(), stats.collect() as ms:
            net(*[torch.from_numpy(a).to(DEVICE) for a in inputs])
        counts = ms.counts(MOE_E).cpu()
    log(f"E4: losses {[round(x, 4) for x in losses]}; launches over "
        f"{BERT_MOE_STEPS} steps: grouped_matmul {gm} (= 2 x {L} x "
        f"{BERT_MOE_STEPS}: {gm == 2 * L * BERT_MOE_STEPS}), "
        f"layernorm_residual {ln} (= 24 x {BERT_MOE_STEPS}), "
        f"softmax_cross_entropy {sx}")
    assert gm == 2 * L * BERT_MOE_STEPS, gm
    assert ln == 2 * L * BERT_MOE_STEPS and sx == BERT_MOE_STEPS, (ln, sx)
    lnb = ln_backward_gate(layernorm_residual, ln, "E4")
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    routed, dropped = int(counts[0].sum()), int(counts[1].sum())
    assert routed + dropped == L * MOE_K * BERT_MOE_B * BERT_MOE_S
    step_ms = wall / BERT_MOE_STEPS * 1e3
    sps = BERT_MOE_B * BERT_MOE_STEPS / wall
    log(f"E4[{gpu}]: {BERT_MOE_STEPS} steps in {wall:.3f}s = {step_ms:.1f} "
        f"ms/step, {sps:.1f} seq/s, peak device memory {peak / 2**20:.0f} "
        f"MiB; after the last step routed {routed}, dropped {dropped}: "
        f"overflow fraction {dropped / (routed + dropped):.4f}")
    del model, opt, net
    checked = check_compression_shapes(torch, seen, "E4")
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {"grouped_matmul": gm, "layernorm_residual": ln,
                         "layernorm_residual_backward": lnb,
                         "softmax_cross_entropy": sx},
            "step_ms": step_ms, "seq_per_s": sps, "peak_bytes": peak,
            "first_loss": losses[0], "last_loss": losses[-1],
            "overflow_frac": dropped / (routed + dropped),
            "path_checks": checked}


def quantized_bert(torch, gpu):
    """Phase E5: ``BertForSequenceClassification(bert_base(quantization=
    mode))`` in eval through ``Model.predict_batch`` at 32 x 128: 48
    ``quantized_matmul`` and 24 ``layernorm_residual`` launches a
    forward, logits within ``E_QTOL`` x max|logit| of the float model from
    the same seed; the card against the CPU's plain route at 2 x 128,
    layer by layer (``layer_parity``) and end to end (float32 rounding
    upstream flips activation codes: within ``E_QTOL``)."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed.meta_parallel import (
        ColumnParallelLinear, RowParallelLinear)
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         bert_base)
    from paddle_tpu_torch.ops import layernorm_residual
    from paddle_tpu_torch.ops.quantized_matmul import quantized_linear

    def build(mode, device):
        cfg = bert_base(quantization=mode or "none")
        return BertForSequenceClassification(
            cfg, device=device,
            generator=torch.Generator().manual_seed(SEED + 95)).eval()

    rng = np.random.RandomState(SEED + 96)
    ids = rng.randint(0, 30522, size=(QBERT_B, BERT_S)).astype(np.int32)
    tt = (rng.uniform(size=(QBERT_B, BERT_S)) < 0.5).astype(np.int32)
    am = np.ones((QBERT_B, BERT_S), np.int32)
    am[1::2, 100:] = 0  # padded rows
    batch = [ids, tt, am]

    def predictor(net):
        return ptt.Model(net, ["input_ids", "token_type_ids",
                               "attention_mask"])

    def run(net):
        model = predictor(net)
        out = model.predict_batch(batch)
        torch.cuda.synchronize()
        times = []
        for _ in range(QBERT_RUNS):
            t0 = time.monotonic()
            model.predict_batch(batch)
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
        return out, sorted(times)[len(times) // 2]

    fnet = build(None, DEVICE)
    ref, f_s = run(fnet)
    del fnet
    res = {"float": {"ms": f_s * 1e3, "seq_per_s": QBERT_B / f_s}}
    with path_shapes() as seen:
        for mode in QUANT_MODES:
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            net = build(mode, DEVICE)
            quantized_linear.launches = 0
            layernorm_residual.launches = 0
            out = predictor(net).predict_batch(batch)
            torch.cuda.synchronize()
            qm, ln = quantized_linear.launches, layernorm_residual.launches
            assert qm == 48 and ln == 24, (mode, qm, ln)
            _, q_s = run(net)
            peak = torch.cuda.max_memory_allocated()
            err = float((out - ref).abs().max()) / float(ref.abs().max())
            assert out.shape == (QBERT_B, 2) and bool(
                torch.isfinite(out).all())
            assert err < E_QTOL[mode], (mode, err)
            # card vs the CPU's plain route: every quantized linear on the
            # same input, then the same seeded model end to end (float32
            # rounding upstream flips activation codes: within E3's rule)
            sub = [a[:QBERT_PARITY_B] for a in batch]
            held = layer_parity(
                torch, net, (ColumnParallelLinear, RowParallelLinear),
                [torch.as_tensor(a, device=DEVICE) for a in sub],
                f"E5[{mode}]", exact=mode == "int8")
            cpu = build(mode, "cpu")
            want = predictor(cpu).predict_batch(sub)
            got = predictor(net).predict_batch(sub).cpu()
            cerr = float((got - want).abs().max()) / float(
                want.abs().max())
            assert cerr < E_QTOL[mode], (mode, cerr)
            log(f"E5[{mode}]: one forward launched quantized_matmul {qm} "
                f"(= 48) and layernorm_residual {ln} (= 24) times; logits "
                f"within {err:.4f} x max|logit| of the float model's (< "
                f"{E_QTOL[mode]}); card vs CPU at {QBERT_PARITY_B} x "
                f"{BERT_S}: {held} layer calls equal, logits {cerr:.2e} x "
                f"max|logit| apart (< {E_QTOL[mode]})")
            log(f"E5[{mode}][{gpu}]: {q_s * 1e3:.2f} ms a forward = "
                f"{QBERT_B / q_s:.1f} seq/s (float {f_s * 1e3:.2f} ms = "
                f"{QBERT_B / f_s:.1f} seq/s), peak device memory "
                f"{peak / 2**20:.0f} MiB")
            res[mode] = {"launches": {"quantized_matmul": qm,
                                      "layernorm_residual": ln},
                         "ms": q_s * 1e3, "seq_per_s": QBERT_B / q_s,
                         "logits_err_vs_float": err,
                         "card_vs_cpu_layers": held,
                         "card_vs_cpu_err": cerr, "peak_bytes": peak}
            del net, cpu
    res["path_checks"] = check_path_kernels(torch, seen, "E5")
    gc.collect()
    torch.cuda.empty_cache()
    return res


def timing_compression(torch, gpu):
    """Phase C1: kernel 9 on caller-quantized int8 codes at the slice's
    new shapes (``C1_SHAPES``): bit-equal to the plain version, then
    timed by CUDA graph beside the eager call, the plain version,
    ``torch._int_mm`` (M > 16, K and N multiples of 8) and the bound."""
    from paddle_tpu_torch.ops.quantized_matmul import (_matmul_kernel,
                                                       _matmul_ref)

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 97)
    rows = {}
    for name, M, K, N in C1_SHAPES:
        qp_check(torch, M, K, N, gen)
        n_w = max(1, -(-64_000_000 // (K * N)))
        xq = torch.randint(-127, 128, (M, K), generator=gen,
                           dtype=torch.int8, device=DEVICE)
        args = [(xq, torch.randint(-127, 128, (K, N), generator=gen,
                                   dtype=torch.int8, device=DEVICE),
                 torch.rand(N, generator=gen, device=DEVICE) * 1e-3,
                 torch.randn(N, generator=gen, device=DEVICE))
                for _ in range(min(n_w, 8))]
        nbytes = M * K + K * N + 8 * N + 4 * M * N
        ops = 2.0 * M * K * N
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / TENSOR_8BIT_OPS
        b_ms = max(t_b, t_o) * 1e3
        b_by = "bytes" if t_b >= t_o else "operations"
        iters = max(10, min(100, int(5.0 / max(b_ms, 0.01))))
        ms = graph_ms(torch, _matmul_kernel, args, iters)
        call = time_ms(torch, _matmul_kernel, args, iters)
        plain = time_ms(torch, _matmul_ref, args, 3)
        lib, why = None, "none: torch._int_mm needs M > 16, K and N % 8 == 0"
        if M > 16 and K % 8 == 0 and N % 8 == 0:
            try:
                lib = graph_ms(torch, lambda x, w, s, b: torch._int_mm(x, w),
                               args, iters)
            except RuntimeError as e:  # the yardstick, not the port
                why = f"none: {str(e).splitlines()[0][:120]}"
        lib_s = f"{lib:.4f} ms" if lib is not None else why
        log(f"timing[{gpu}] quantized_matmul int8 {name} [{M}, {K}] @ [{K}, "
            f"{N}]: kernel {ms:.4f} ms (graph; eager call {call:.4f} ms) = "
            f"{nbytes / ms / 1e6:.1f} GB/s and {ops / ms / 1e9:.2f} TOP/s, "
            f"plain {plain:.4f} ms, library (_int_mm, product only) "
            f"{lib_s}, bound {b_ms:.5f} ms by {b_by} ({nbytes} bytes, "
            f"{ops:.4g} ops); bit-equal to plain")
        rows[name] = dict(M=M, K=K, N=N, ms=ms, call_ms=call,
                          plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                          bound_by=b_by)
        del xq, args
    torch.cuda.synchronize()
    getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def timed_forward(torch, net, x, runs):
    """Median seconds of ``runs`` forwards without gradient (after one
    untimed call)."""
    times = []
    with torch.no_grad():
        net(x)
        torch.cuda.synchronize()
        for _ in range(runs):
            t0 = time.monotonic()
            net(x)
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
    return sorted(times)[len(times) // 2]


def int8_layers(slim, net):
    """(Int8Conv2D layers with groups 1, grouped ones, Int8Linear
    layers) of ``net``."""
    convs = [l for _, l in net.named_sublayers()
             if isinstance(l, slim.Int8Conv2D)]
    dense = [c for c in convs if c._cfg[3] == 1]
    linears = [l for _, l in net.named_sublayers()
               if isinstance(l, slim.Int8Linear)]
    return dense, [c for c in convs if c._cfg[3] != 1], linears


def resnet_ptq(torch, gpu):
    """Phase C2: ResNet-50 (NHWC, bf16, eval, 128 x 224², the 7 x 7 stem)
    through ``PostTrainingQuantization`` over ``C2_CALIB`` seeded
    calibration batches, then ``quantize()``: every convolution and the
    classifier an int8 layer, kernel 9 launched once for each a forward;
    the int8 logits within ``C2_REL_L2`` (relative L2) of the float
    model's; the int8 model on the card against its copy on the CPU, layer
    by layer (bit-equal) and end to end."""
    import copy

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import slim
    from paddle_tpu_torch.ops.quantized_matmul import quantized_linear

    net = ptt.vision.models.resnet50(
        data_format="NHWC", device=DEVICE,
        generator=torch.Generator().manual_seed(SEED)).astype(
            "bfloat16").eval()
    gdev = torch.Generator(device=DEVICE)

    def images(seed, n=C2_B, hw=C2_HW):
        gdev.manual_seed(seed)
        return (torch.rand(n, hw, hw, 3, device=DEVICE, generator=gdev)
                * 2 - 1).to(torch.bfloat16)

    x = images(SEED + 98)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ref = net(x)
    f_s = timed_forward(torch, net, x, C2_RUNS)
    f_peak = torch.cuda.max_memory_allocated()
    t0 = time.monotonic()
    ptq = slim.PostTrainingQuantization(net)
    for i in range(C2_CALIB):
        ptq.collect(images(SEED + 100 + i))
    qnet = ptq.quantize()
    calib_s = time.monotonic() - t0
    dense, grouped, linears = int8_layers(slim, qnet)
    n9 = len(dense) + len(linears)
    assert not grouped and n9 == 54, (len(dense), len(grouped), len(linears))
    torch.cuda.reset_peak_memory_stats()
    with compression_shapes() as seen, torch.no_grad():
        quantized_linear.launches = 0
        out = qnet(x)
        torch.cuda.synchronize()
        launches = quantized_linear.launches
    q_s = timed_forward(torch, qnet, x, C2_RUNS)
    q_peak = torch.cuda.max_memory_allocated()
    assert launches == n9, (launches, n9)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all())
    err = rel_l2(out, ref)
    assert err < C2_REL_L2, err
    # the same int8 model on the CPU (its plain route) on 2 images: each
    # int8 layer on its card input, then end to end
    x2 = images(SEED + 110, C2_CPU["B"], C2_CPU["HW"])
    held = layer_parity(torch, qnet, (slim.Int8Conv2D, slim.Int8Linear),
                        (x2,), "C2")
    cpu = copy.deepcopy(qnet).to("cpu")
    with torch.no_grad():
        got, want = qnet(x2).cpu(), cpu(x2.cpu())
    cerr = rel_l2(got, want)
    assert cerr < C2_CPU_REL_L2, cerr
    log(f"C2: {len(dense)} Int8Conv2D + {len(linears)} Int8Linear layers "
        f"after {C2_CALIB} calibration batches of {C2_B} x {C2_HW}² "
        f"({calib_s:.1f}s); one int8 forward launched kernel 9 {launches} "
        f"times (= {n9}); logits' relative L2 error to the float model "
        f"{err:.4f} (< {C2_REL_L2}); card vs CPU at {C2_CPU['B']} x "
        f"{C2_CPU['HW']}²: {held} int8 layer calls bit-equal, logits "
        f"{cerr:.2e} apart (< {C2_CPU_REL_L2})")
    log(f"C2[{gpu}]: int8 forward {q_s * 1e3:.1f} ms = {C2_B / q_s:.1f} "
        f"img/s (peak {q_peak / 2**20:.0f} MiB); float bf16 forward "
        f"{f_s * 1e3:.1f} ms = {C2_B / f_s:.1f} img/s (peak "
        f"{f_peak / 2**20:.0f} MiB)")
    checked = check_compression_shapes(torch, seen, "C2")
    del net, qnet, cpu, ptq, x, ref, out
    gc.collect()
    torch.cuda.empty_cache()
    return {"int8_layers": n9, "launches": launches, "rel_l2_vs_float": err,
            "card_vs_cpu_layers": held, "card_vs_cpu_rel_l2": cerr,
            "int8_img_per_s": C2_B / q_s,
            "float_img_per_s": C2_B / f_s, "int8_ms": q_s * 1e3,
            "float_ms": f_s * 1e3, "int8_peak_bytes": q_peak,
            "float_peak_bytes": f_peak, "path_checks": checked}


def mobilenet_qat(torch, gpu):
    """Phase C3: MobileNetV2 (f32, 1000 classes) under
    ``ImperativeQuantAware()`` — abs-max weights, moving-average
    activations — trained with Momentum(0.01, 0.9) through
    ``Model.train_batch`` at 64 x 224², then ``convert()`` to int8 and
    evaluated (the depthwise convolutions through the exact grouped
    route, the others through kernel 9)."""
    import copy

    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import slim
    from paddle_tpu_torch.ops.quantized_matmul import quantized_linear

    net = ptt.vision.models.mobilenet_v2(
        device=DEVICE, generator=torch.Generator().manual_seed(SEED))
    slim.ImperativeQuantAware().quantize(net)
    observers = [l for _, l in net.named_sublayers()
                 if isinstance(l, slim.FakeQuantMovingAverage)]
    opt = ptt.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
    model = ptt.Model(net, inputs=1, labels=1).prepare(
        optimizer=opt, loss=ptt.nn.CrossEntropyLoss())
    rng = np.random.RandomState(SEED + 120)
    xs = rng.uniform(-1, 1, (C3_B, 3, C3_HW, C3_HW)).astype(np.float32)
    ys = rng.randint(0, 1000, (C3_B, 1)).astype(np.int64)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, wall, _ = train_steps(torch, model, [xs], [ys], C3_WARMUP,
                                  C3_STEPS, ())
    t_peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(v) for v in losses), losses
    # every observer saw every training step: state_n = 0.9 state + 1
    state = torch.ones(1)
    for _ in range(C3_WARMUP + C3_STEPS):
        state = state * 0.9 + 1.0
    moved = [torch.allclose(o._state.cpu(), state, rtol=1e-6, atol=0)
             for o in observers]
    assert len(observers) == 53 and all(moved), (len(observers),
                                                 sum(moved))
    x = torch.from_numpy(xs).to(DEVICE)
    net.eval()
    with torch.no_grad():
        fq = net(x)
    slim.ImperativeQuantAware().convert(net)
    dense, grouped, linears = int8_layers(slim, net)
    n9 = len(dense) + len(linears)
    torch.cuda.reset_peak_memory_stats()
    with compression_shapes() as seen, torch.no_grad():
        quantized_linear.launches = 0
        out = net(x)
        torch.cuda.synchronize()
        launches = quantized_linear.launches
    q_s = timed_forward(torch, net, x, C3_RUNS)
    q_peak = torch.cuda.max_memory_allocated()
    assert launches == n9 and len(grouped) == 17, (launches, n9,
                                                   len(grouped))
    assert bool(torch.isfinite(out).all())
    err = rel_l2(out, fq)
    assert err < C3_REL_L2, err
    held = layer_parity(torch, net, (slim.Int8Conv2D, slim.Int8Linear),
                        (x[:C3_CPU_B],), "C3")
    cpu = copy.deepcopy(net).to("cpu")
    with torch.no_grad():
        got, want = net(x[:C3_CPU_B]).cpu(), cpu(x[:C3_CPU_B].cpu())
    cerr = rel_l2(got, want)
    assert cerr < C3_CPU_REL_L2, cerr
    step_ms = wall / C3_STEPS * 1e3
    log(f"C3: QAT losses {[round(v, 4) for v in losses]}; all "
        f"{len(observers)} activation observers' _state = {float(state):.6f}"
        f" after {C3_WARMUP + C3_STEPS} steps; convert: {len(dense)} "
        f"Int8Conv2D through kernel 9, {len(grouped)} depthwise through "
        f"the exact grouped route, {len(linears)} Int8Linear; one int8 "
        f"forward launched kernel 9 {launches} times (= {n9}); int8 logits' "
        f"relative L2 error to the fake-quant eval {err:.4f} (< "
        f"{C3_REL_L2}); card vs CPU on {C3_CPU_B} images: {held} int8 layer "
        f"calls bit-equal, logits {cerr:.2e} apart (< {C3_CPU_REL_L2})")
    log(f"C3[{gpu}]: QAT step {step_ms:.1f} ms = "
        f"{C3_B * C3_STEPS / wall:.1f} img/s (peak {t_peak / 2**20:.0f} "
        f"MiB); int8 forward {q_s * 1e3:.1f} ms = {C3_B / q_s:.1f} img/s "
        f"(peak {q_peak / 2**20:.0f} MiB)")
    checked = check_compression_shapes(torch, seen, "C3")
    del model, opt, net, cpu, x
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "observers": len(observers),
            "qat_step_ms": step_ms, "qat_img_per_s": C3_B * C3_STEPS / wall,
            "int8_img_per_s": C3_B / q_s, "int8_ms": q_s * 1e3,
            "kernel9_layers": n9, "depthwise_layers": len(grouped),
            "launches": launches, "rel_l2_vs_fake_quant": err,
            "card_vs_cpu_layers": held, "card_vs_cpu_rel_l2": cerr,
            "qat_peak_bytes": t_peak,
            "int8_peak_bytes": q_peak, "path_checks": checked}


def compression_phases(torch, gpu, d1, m4):
    """E1-E5 and C1-C3, then the ``{"compression": ...}`` line; returns
    what the kernels line needs."""
    e13 = moe_serving_phases(torch, gpu, d1, m4)
    submark("E4")
    e4 = bert_moe_train(torch, gpu)
    submark("E5")
    e5 = quantized_bert(torch, gpu)
    submark("C1")
    c1 = timing_compression(torch, gpu)
    submark("C2")
    c2 = resnet_ptq(torch, gpu)
    submark("C3")
    c3 = mobilenet_qat(torch, gpu)
    log(json.dumps({"compression": {
        "device": gpu, "E1_moe_dense": e13["E1"],
        "E1_moe_legacy": e13["E1_legacy"], "E2_moe_dense_cf1.25": e13["E2"],
        "E3_quantized_moe": e13["E3"], "E4_bert_moe": e4,
        "E5_quantized_bert": e5, "C1_kernel9": c1, "C2_resnet50_ptq": c2,
        "C3_mobilenet_v2_qat": c3}}, default=str))
    return {"E": e13, "E4": e4, "E5": e5, "C1": c1, "C2": c2, "C3": c3}


# -- the vision slice: convolutions, pools and the image data path ----------
V_TOL = 2e-3        # card vs CPU, float32: max |diff| / rms(CPU result)
V_B = 128           # V2's batch; 512 images, 4 steps an epoch
V_IMAGES, V_CLASSES, V_HW, V_CROP = 512, 10, 256, 224
V_WORKERS = 8
V_MEAN, V_STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
#: DCGAN's generator (nz 100 → 512 → 256 → 128 → 64 → 3, 4² → 64²) at
#: batch 128: (C_in, C_out, input side) of its stride-2 transposed convs
V_DCGAN = ((512, 256, 4), (256, 128, 8), (128, 64, 16), (64, 3, 32))
V_DCGAN_B = 128
V_C3D = dict(x=(8, 64, 16, 56, 56), cin=64, cout=128)
V_CONV1D = (32, 256, 1024)
#: the pools' inputs, channels-first, fewer than 2^24 elements each so a
#: permutation of integers is exact in float32 (unique window maxima);
#: the even sizes take ceil_mode's extra padding at k3 s2 p1
V_POOL_SHAPES = {1: (32, 64, 1000), 2: (32, 64, 56, 57),
                 3: (8, 32, 14, 29, 28)}
V_ADAPTIVE = {1: 7, 2: (7, 5), 3: (4, 5, 6)}
V_FORMATS = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}


def _v_err(torch, got, ref):
    """max |got - ref| / rms(ref), on the CPU in float64."""
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    rms = float(ref.pow(2).mean().sqrt()) or 1.0
    return float((got - ref).abs().max()) / rms


def _v_unique(torch, shape, seed):
    """A seeded permutation of the integers, centred: every value
    distinct and exact in float32."""
    n = math.prod(shape)
    assert n < 2 ** 24, shape
    g = torch.Generator().manual_seed(seed)
    return (torch.randperm(n, generator=g).float() - n / 2).reshape(shape)


def _v_window_unique(torch, shape, seed):
    """Values distinct inside every 2 x 2 x 2 window of a channels-first
    3-D input (a window's 8 ranks are a seeded permutation over a seeded
    base): MaxPool3D(2)'s maxima are unique at any size."""
    B, C, D, H, W = shape
    g = torch.Generator().manual_seed(seed)
    cells = (B, C, D // 2, H // 2, W // 2)
    ranks = torch.rand(cells + (8,), generator=g).argsort(-1).float()
    base = torch.randint(0, 4096, cells + (1,), generator=g).float() * 8
    return (base + ranks).reshape(cells + (2, 2, 2)).permute(
        0, 1, 2, 5, 3, 6, 4, 7).reshape(shape)


def _v_pair(torch, label, layer, x, seed, kwargs=None):
    """``layer`` (on the CPU) and a copy on the card on one input:
    the output, the mask (equal, or None in both) and the gradients of
    ``Σ out · c`` for the input and every parameter; the largest error
    of them, and the card's forward ms."""
    import copy

    kwargs = kwargs or {}
    card = copy.deepcopy(layer).to(DEVICE)
    xc = x.clone().requires_grad_(True)
    xd = x.to(DEVICE).requires_grad_(True)
    outs = []
    for net, xx in ((layer, xc), (card, xd)):
        out = net(xx, **kwargs)
        outs.append(out if isinstance(out, tuple) else (out, None))
    (oc, mc), (od, md) = outs
    assert tuple(oc.shape) == tuple(od.shape), (label, oc.shape, od.shape)
    cot = torch.randn(oc.shape, generator=torch.Generator().manual_seed(seed))
    gc_ = torch.autograd.grad((oc * cot).sum(), [xc, *layer.parameters()])
    gd = torch.autograd.grad((od * cot.to(DEVICE)).sum(),
                             [xd, *card.parameters()])
    errs = [_v_err(torch, od, oc)] + [_v_err(torch, d, c)
                                      for d, c in zip(gd, gc_)]
    if mc is None or md is None:
        assert mc is None and md is None, label
        mask = None
    else:
        mask = bool(torch.equal(mc, md.cpu()))
        assert mask, f"V1 {label}: the card's mask differs from the CPU's"
    err = max(errs)
    assert err <= V_TOL, (label, errs)
    with torch.no_grad():
        ms = time_ms(torch, lambda t: card(t, **kwargs), [(xd.detach(),)], 5)
    row = {"max_err": err, "mask_equal": mask, "shape": list(x.shape),
           "ms": ms}
    log(f"V1 {label}: out {list(oc.shape)} max err {err:.2e} (tol "
        f"{V_TOL:.0e} x rms){'' if mask is None else ', mask equal'}; card "
        f"forward {ms:.4f} ms")
    return row


def vision_ops_card_vs_cpu(torch):
    """Phase V1: every op of the vision slice on the card against the
    port's CPU result on one seeded float32 input (forward; gradients of
    ``Σ out · c`` for the input and every parameter; all within V_TOL of
    the CPU result's rms), masks equal."""
    import paddle_tpu_torch.nn as nn

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def made(layer, seed):
        layer.reset_parameters(gen(seed))
        return layer

    rows, seed = {}, SEED + 900
    # DCGAN's generator: the k4 s1 p0 input layer, then the four k4 s2 p1
    # layers with and without output_size, and the last one cropped
    z = torch.randn((V_DCGAN_B, 100, 1, 1), generator=gen(seed))
    rows["dcgan_input_100_512"] = _v_pair(torch, "ConvT2D 100->512 1->4", made(
        nn.Conv2DTranspose(100, 512, 4), seed), z, seed)
    for cin, cout, side in V_DCGAN:
        seed += 1
        x = torch.randn((V_DCGAN_B, cin, side, side), generator=gen(seed))
        layer = made(nn.Conv2DTranspose(cin, cout, 4, stride=2, padding=1),
                     seed)
        for size in (None, [2 * side, 2 * side]) + (
                ([2 * side - 1, 2 * side - 3],) if cout == 3 else ()):
            tag = "" if size is None else f" output_size={size}"
            rows[f"dcgan_{cin}_{cout}{tag}"] = _v_pair(
                torch, f"ConvT2D k4s2p1 {cin}->{cout} {side}->"
                f"{2 * side}{tag}", layer, x, seed,
                {} if size is None else {"output_size": size})
    # C3D: Conv3D(64 -> 128, k3, p1), then MaxPool3D(2) with its mask
    seed += 1
    x3 = torch.randn(V_C3D["x"], generator=gen(seed))
    rows["c3d_conv3d"] = _v_pair(torch, "Conv3D 64->128 k3p1", made(
        nn.Conv3D(V_C3D["cin"], V_C3D["cout"], 3, padding=1), seed), x3, seed)
    seed += 1
    xp = _v_window_unique(torch, (V_C3D["x"][0], V_C3D["cout"])
                          + V_C3D["x"][2:], seed)
    rows["c3d_maxpool3d_mask"] = _v_pair(
        torch, "MaxPool3D(2, return_mask)", nn.MaxPool3D(2, return_mask=True),
        xp, seed)
    # Conv1D / Conv1DTranspose at [32, 256, 1024]
    seed += 1
    x1 = torch.randn(V_CONV1D, generator=gen(seed))
    rows["conv1d"] = _v_pair(torch, "Conv1D 256->256 k3p1", made(
        nn.Conv1D(256, 256, 3, padding=1), seed), x1, seed)
    rows["conv1d_transpose"] = _v_pair(torch, "Conv1DTranspose k4s2p1", made(
        nn.Conv1DTranspose(256, 256, 4, stride=2, padding=1), seed + 1), x1,
        seed + 1)
    # the channels-last layouts of the convolutions (NLC, NHWC, NDHWC)
    x1l = x1.movedim(1, -1).contiguous()
    rows["conv1d NLC"] = _v_pair(torch, "Conv1D NLC 256->256 k3p1", made(
        nn.Conv1D(256, 256, 3, padding=1, data_format="NLC"), seed), x1l,
        seed)
    rows["conv1d_transpose NLC"] = _v_pair(
        torch, "Conv1DTranspose NLC k4s2p1", made(nn.Conv1DTranspose(
            256, 256, 4, stride=2, padding=1, data_format="NLC"), seed + 1),
        x1l, seed + 1)
    seed += 2
    x2l = torch.randn((V_DCGAN_B, 512, 4, 4), generator=gen(
        seed)).movedim(1, -1).contiguous()
    rows["dcgan_512_256 NHWC"] = _v_pair(
        torch, "ConvT2D NHWC k4s2p1 512->256", made(nn.Conv2DTranspose(
            512, 256, 4, stride=2, padding=1, data_format="NHWC"), seed),
        x2l, seed)
    x3l = torch.randn((2, 64, 16, 56, 56), generator=gen(
        seed)).movedim(1, -1).contiguous()
    rows["conv3d NDHWC"] = _v_pair(torch, "Conv3D NDHWC 64->128 k3p1", made(
        nn.Conv3D(64, 128, 3, padding=1, data_format="NDHWC"), seed), x3l,
        seed)
    rows["conv3d_transpose NDHWC"] = _v_pair(
        torch, "Conv3DTranspose NDHWC k2s2", made(nn.Conv3DTranspose(
            64, 32, 2, stride=2, data_format="NDHWC"), seed), x3l, seed)
    # every pool in both layouts at ceil_mode and exclusive True / False
    for n, shape in V_POOL_SHAPES.items():
        seed += 1
        base = _v_unique(torch, shape, seed)
        for last, fmt in enumerate(V_FORMATS[n]):
            x = base.movedim(1, -1).contiguous() if last else base
            for ceil in (False, True):
                for excl in (True, False):
                    rows[f"avg_pool{n}d {fmt} ceil={ceil} excl={excl}"] = \
                        _v_pair(torch, f"AvgPool{n}D {fmt} k3s2p1 ceil={ceil}"
                                f" exclusive={excl}", getattr(
                                    nn, f"AvgPool{n}D")(
                                    3, 2, 1, ceil_mode=ceil, exclusive=excl,
                                    data_format=fmt), x, seed)
                rows[f"max_pool{n}d {fmt} ceil={ceil} mask"] = _v_pair(
                    torch, f"MaxPool{n}D {fmt} k3s2p1 ceil={ceil} mask",
                    getattr(nn, f"MaxPool{n}D")(
                        3, 2, 1, ceil_mode=ceil, return_mask=True,
                        data_format=fmt), x, seed)
        # the adaptive pools at non-divisible sizes; the max pools' masks
        # are None, as the JAX package's
        size = V_ADAPTIVE[n]
        rows[f"adaptive_max_pool{n}d mask"] = _v_pair(
            torch, f"AdaptiveMaxPool{n}D {size} mask", getattr(
                nn, f"AdaptiveMaxPool{n}D")(size, return_mask=True),
            base, seed)
        rows[f"adaptive_avg_pool{n}d"] = _v_pair(
            torch, f"AdaptiveAvgPool{n}D {size}", getattr(
                nn, f"AdaptiveAvgPool{n}D")(size), base, seed)
    worst = max(r["max_err"] for r in rows.values())
    masks = sum(1 for r in rows.values() if r["mask_equal"])
    log(f"V1: {len(rows)} ops card vs CPU, float32, forward and backward: "
        f"largest error {worst:.2e} x rms (tol {V_TOL:.0e}); {masks} masks "
        f"equal")
    return {"cases": rows, "max_err": worst, "masks_equal": masks,
            "tol": V_TOL}


def _v_write_images(np, root):
    """V_IMAGES seeded uint8 HWC images as ``.npy`` files in V_CLASSES
    folders (image i in class i % V_CLASSES)."""
    rng = np.random.RandomState(SEED + 901)
    for c in range(V_CLASSES):
        os.makedirs(os.path.join(root, f"class_{c:02d}"))
    for i in range(V_IMAGES):
        np.save(os.path.join(root, f"class_{i % V_CLASSES:02d}",
                             f"{i:04d}.npy"),
                rng.randint(0, 256, (V_HW, V_HW, 3), dtype=np.uint8))


def vision_data_path(torch, gpu):
    """Phase V2: ResNet-50 (NHWC, space-to-depth stem, bf16, 10 classes)
    trained from image files through ``Model.fit``: ``.npy`` class folders
    read by ``DatasetFolder(loader=numpy.load)`` through ``RandomCrop`` /
    ``RandomHorizontalFlip`` / ``ToTensor`` / ``Normalize`` in an 8-worker
    ``DataLoader``, one warm-up ``train_batch`` and one epoch; kernels 7
    and 8 counted each step.  Then the same model's ``train_batch`` on a
    batch already on the card.  Returns the numbers and the trained
    network, its save directory and one batch for V3."""
    import shutil
    import tempfile

    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import vision
    from paddle_tpu_torch.ops import bn_apply_relu, conv1x1_bn_stats

    T = vision.transforms
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vision_")
    try:
        t0 = time.monotonic()
        _v_write_images(np, tmp)
        written = time.monotonic() - t0
        data = vision.datasets.DatasetFolder(
            tmp, loader=np.load, extensions=(".npy",),
            transform=T.Compose([
                T.RandomCrop(V_CROP), T.RandomHorizontalFlip(),
                T.ToTensor(data_format="HWC"),
                T.Normalize(V_MEAN, V_STD, data_format="HWC")]))
        assert len(data) == V_IMAGES and len(data.classes) == V_CLASSES
        loader = ptt.io.DataLoader(data, batch_size=V_B, shuffle=True,
                                   drop_last=True, num_workers=V_WORKERS,
                                   places=DEVICE)
        net = resnet_model(torch, "bfloat16", DEVICE,
                           torch.Generator().manual_seed(SEED),
                           num_classes=V_CLASSES)
        model = resnet_trainer(torch, net)
        # the warm-up step, on a batch read in this process
        first = ptt.io.default_collate_fn([data[i] for i in range(V_B)])
        xw = torch.from_numpy(first[0]).to(DEVICE)
        yw = torch.from_numpy(first[1]).to(DEVICE)
        model.train_batch([xw], [yw])
        counts_cb, counts = _counts_per_execution(
            [(conv1x1_bn_stats, "launches"), (bn_apply_relu, "launches")])
        timer = ExecutionTimer(torch)
        begins = []  # host clock at each step's begin

        class _Begins(ptt.hapi.callbacks.Callback):
            def on_train_batch_begin(self, step, logs=None):
                begins.append(time.perf_counter())

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(loader, epochs=1, verbose=0,
                  callbacks=[_Begins(), counts_cb, timer.callback])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        begin_s = [b - t0 for b in begins]
        steps = V_IMAGES // V_B
        losses = timer.losses
        assert len(counts) == steps, counts
        want = RESNET_BLOCKS
        assert all(c == (want, want) for c in counts), counts
        assert all(math.isfinite(v) for v in losses), losses
        # the same model's train_batch on a batch already on the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            model.train_batch([xw], [yw])
        torch.cuda.synchronize()
        tb_s = time.perf_counter() - t0
        fit_ips = steps * V_B / fit_s
        tb_ips = steps * V_B / tb_s
        step_wall = sum(timer.wall)
        out = {
            "images": V_IMAGES, "classes": V_CLASSES, "image_hw": V_HW,
            "crop": V_CROP, "batch": V_B, "workers": V_WORKERS,
            "steps": steps, "write_s": written,
            "launches_per_step": [list(c) for c in counts],
            "losses": losses, "fit_s": fit_s, "fit_img_per_s": fit_ips,
            "step_wall_s": step_wall,
            "first_step_wall_s": timer.wall[0],
            # fit's start to each step's begin: the worker pool's start
            # and the first batch, then the later batches' waits
            "step_begin_s": begin_s,
            "train_batch_s": tb_s, "train_batch_img_per_s": tb_ips,
            "input_pipeline_share": 1.0 - tb_s / fit_s}
        log(f"V2 ResNet-50 bf16 from {V_IMAGES} .npy images (10 classes, "
            f"{V_HW}^2 -> RandomCrop {V_CROP}, flip, ToTensor, Normalize; "
            f"{V_WORKERS} workers)[{gpu}]: one epoch of {steps} steps through "
            f"fit in {fit_s:.3f}s = {fit_ips:.1f} img/s end to end "
            f"(worker start included: the steps began at "
            f"{[round(b, 3) for b in out['step_begin_s']]} s; the steps' "
            f"wall {step_wall} s, the first {out['first_step_wall_s']} s); "
            f"train_batch on a batch on the "
            f"card {tb_s / steps * 1e3:.2f} ms/step = {tb_ips:.1f} img/s; "
            f"input pipeline share {out['input_pipeline_share']:.3f}; "
            f"losses {losses}; launches per step (conv1x1_bn_stats, "
            f"bn_apply_relu) {counts} (= {want} each)")
        return out, net, xw
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def vision_pretrained(torch, gpu, net, x):
    """Phase V3: V2's trained network saved with ``paddle_tpu_torch.save``
    and rebuilt with ``resnet50(pretrained=path)``: eval logits on one
    batch bit for bit."""
    import shutil
    import tempfile

    import paddle_tpu_torch as ptt

    tmp = tempfile.mkdtemp(prefix="chip_smoke_pretrained_")
    try:
        path = os.path.join(tmp, "resnet50.pdparams")
        t0 = time.monotonic()
        ptt.save(net.state_dict(), path)
        save_s = time.monotonic() - t0
        size = os.path.getsize(path)
        t0 = time.monotonic()
        again = ptt.vision.models.resnet50(
            pretrained=path, num_classes=V_CLASSES, data_format="NHWC",
            stem_space_to_depth=True, device=DEVICE).astype("bfloat16")
        load_s = time.monotonic() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    net.eval()
    again.eval()
    with torch.no_grad():
        want, got = net(x), again(x)
    equal = bool(torch.equal(want, got))
    log(f"V3 resnet50(pretrained=path)[{gpu}]: checkpoint {size} bytes, "
        f"save {save_s:.2f}s, rebuild + load {load_s:.2f}s; eval logits "
        f"{list(got.shape)} {got.dtype} bit-equal to the saved network's: "
        f"{equal}")
    assert equal, "V3: the reloaded network's logits differ"
    return {"bytes": size, "save_s": save_s, "load_s": load_s,
            "logits_bit_equal": equal}


def vision_static(torch, gpu):
    """Phase V4: a ``fluid.Program`` with ``conv2d_transpose``,
    ``conv3d``, ``conv3d_transpose``, ``pool2d(pool_type="avg")`` and
    ``pool3d`` (average and max) run by ``Executor.run`` on the card,
    against the eager layers with the program's parameters on the card
    (rtol 1e-5 of the result's rms: one device, the same kernels)."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.nn.functional as F

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x2 = fluid.data("x2", [-1, 64, 16, 16])
        a = fluid.layers.conv2d_transpose(x2, num_filters=32, filter_size=4,
                                          stride=2, padding=1)
        a = fluid.layers.pool2d(a, pool_size=3, pool_type="avg",
                                pool_stride=2, pool_padding=1,
                                ceil_mode=True, exclusive=False)
        x3 = fluid.data("x3", [-1, 16, 8, 28, 28])
        b = fluid.layers.conv3d(x3, num_filters=32, filter_size=3,
                                padding=1)
        b = fluid.layers.conv3d_transpose(b, num_filters=16, filter_size=2,
                                          stride=2)
        c = fluid.layers.pool3d(b, 3, pool_type="avg", pool_stride=2,
                                pool_padding=1)
        d = fluid.layers.pool3d(b, 2, pool_type="max", pool_stride=2,
                                ceil_mode=True)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    rng = np.random.RandomState(SEED + 902)
    feed = {"x2": rng.randn(16, 64, 16, 16).astype(np.float32),
            "x3": rng.randn(4, 16, 8, 28, 28).astype(np.float32)}
    outs = exe.run(main, feed=feed, fetch_list=[a, c, d])
    scope = {k.split("_", 2)[2].rsplit("_", 1)[0]: v
             for k, v in main.scope.items()}

    def eager(layer, prefix):
        layer = layer.to(DEVICE)
        with torch.no_grad():
            layer.weight.copy_(scope[f"{prefix}.weight"])
            layer.bias.copy_(scope[f"{prefix}.bias"])
        return layer

    with torch.no_grad():
        t2 = torch.from_numpy(feed["x2"]).to(DEVICE)
        t3 = torch.from_numpy(feed["x3"]).to(DEVICE)
        ea = F.avg_pool2d(eager(nn.Conv2DTranspose(64, 32, 4, stride=2,
                                                   padding=1),
                                "conv2d_transpose")(t2),
                          3, 2, 1, ceil_mode=True, exclusive=False)
        eb = eager(nn.Conv3DTranspose(32, 16, 2, stride=2),
                   "conv3d_transpose")(eager(nn.Conv3D(16, 32, 3, padding=1),
                                             "conv3d")(t3))
        ec = nn.AvgPool3D(3, 2, 1)(eb)
        ed = nn.MaxPool3D(2, 2, ceil_mode=True)(eb)
    errs = {}
    for name, got, want in (("conv2d_transpose+pool2d_avg", outs[0], ea),
                            ("conv3d+conv3d_transpose+pool3d_avg", outs[1],
                             ec),
                            ("pool3d_max", outs[2], ed)):
        assert tuple(got.shape) == tuple(want.shape), (name, got.shape)
        errs[name] = _v_err(torch, torch.from_numpy(np.asarray(got)), want)
        assert errs[name] <= 1e-5, (name, errs[name])
    log(f"V4 static vision builders through Executor.run[{gpu}]: outputs "
        f"{[list(o.shape) for o in outs]} against the eager layers with "
        f"the program's parameters: errors {errs} x rms (tol 1e-5)")
    return {"errors": errs, "shapes": [list(o.shape) for o in outs]}


def vision_phases(torch, gpu):
    """V1-V4, then the ``{"vision": ...}`` line; returns what the kernels
    line needs."""
    v1 = vision_ops_card_vs_cpu(torch)
    gc.collect()
    torch.cuda.empty_cache()
    v2, net, x = vision_data_path(torch, gpu)
    v3 = vision_pretrained(torch, gpu, net, x)
    del net, x
    gc.collect()
    torch.cuda.empty_cache()
    v4 = vision_static(torch, gpu)
    log(json.dumps({"vision": {
        "device": gpu, "V1_ops_card_vs_cpu": v1, "V2_resnet50_from_files": v2,
        "V3_pretrained": v3, "V4_static_builders": v4}}, default=str))
    return {"V1": v1, "V2": v2, "V3": v3, "V4": v4}



# -- the detection slice: Faster R-CNN R50-C4 and the detection ops (B1-B4)
B_TOL = 1e-4        # card vs CPU, float32: max |diff| / rms(CPU result)
B_IMAGES, B_HW = 2, (800, 1344)          # short side 800, padded to 32
B_INFO = (800.0, 1333.0, 1.0)            # im_info: resized h, w, scale
B_ANCHORS = dict(anchor_sizes=[32.0, 64.0, 128.0, 256.0, 512.0],
                 aspect_ratios=[0.5, 1.0, 2.0], variances=[1.0] * 4,
                 stride=[16.0, 16.0])
B_GT, B_CLASSES = 20, 81
B_RPN = dict(rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
             rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
             rpn_negative_overlap=0.3)
B_TRAIN_PROPOSALS = dict(pre_nms_top_n=12000, post_nms_top_n=2000,
                         nms_thresh=0.7, min_size=0.0)
B_TEST_PROPOSALS = dict(pre_nms_top_n=6000, post_nms_top_n=1000,
                        nms_thresh=0.7, min_size=0.0)
B_SAMPLING = dict(batch_size_per_im=512, fg_fraction=0.25, fg_thresh=0.5,
                  bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                  bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                  class_nums=B_CLASSES, is_cls_agnostic=True)
# the config's sampling_ratio 0 is JAX's fixed 2 x 2 grid (B2's departure)
B_ROI = dict(pooled_height=14, pooled_width=14, spatial_scale=1.0 / 16,
             sampling_ratio=2)
B_BOX_VAR = [0.1, 0.1, 0.2, 0.2]
B_NMS = dict(score_threshold=0.05, nms_top_k=-1, keep_top_k=100,
             nms_threshold=0.5, normalized=False, background_label=0)
B_WARMUP, B_STEPS = 1, 3
# faster_rcnn_r50_1x's schedule: base lr 0.01 for 8 images a step, scaled
# linearly to B_IMAGES, in its linear warm-up (500 iterations from a third
# of the base lr), which every step of B2 lies in
B_LR, B_LR_WARMUP = 0.01 * B_IMAGES / 8, 500
# B2's divergence gate: no timed step's total loss above this multiple of
# the warm-up step's (at a few ten-thousandths of lr, a step moves the
# weights little; a run that diverges multiplies its loss)
B_LOSS_RISE = 1.25
B_CONFIG = ("faster_rcnn_r50_1x (R50-C4), 2 x 800 x 1344; departures: "
            "roi_align sampling_ratio 2 for the config's 0 (JAX's fixed "
            "grid); BN trains on batch statistics (kernels 7-8) where the "
            "config freezes it as an affine layer over pretrained "
            "statistics; random weights; lr 0.01 scaled linearly from 8 "
            "images to 2, in the config's warm-up")
B_STAGES = ("backbone", "rpn_targets", "proposals", "sampling", "roi_align",
            "head", "backward", "optimizer")
# SSD300 (VGG16, VOC: 21 classes): its six maps, channels and prior config
B_SSD_MAPS = ((512, 38), (1024, 19), (512, 10), (256, 5), (256, 3),
              (256, 1))
B_SSD = dict(min_sizes=[30.0, 60.0, 111.0, 162.0, 213.0, 264.0],
             max_sizes=[60.0, 111.0, 162.0, 213.0, 264.0, 315.0],
             aspect_ratios=[[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0],
                            [2.0], [2.0]],
             steps=[8.0, 16.0, 32.0, 64.0, 100.0, 300.0])
B_SSD_B = 8
# YOLOv3-608 (COCO): the published anchors and masks, strides 32 / 16 / 8
B_YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                  156, 198, 373, 326]
B_YOLO_SCALES = (([6, 7, 8], 19, 32), ([3, 4, 5], 38, 16),
                 ([0, 1, 2], 76, 8))
B_YOLO_B, B_YOLO_GT = 8, 50
B_ROIS = 1024
# RoIs whose CPU reference B1 computes (the card runs all B_ROIS)
B_ROI_CHECK = 128


def _b_err(torch, got, ref):
    """max |got - ref| / rms(ref), in float64 on the CPU."""
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    rms = float(ref.pow(2).mean().sqrt()) or 1.0
    return float((got - ref).abs().max()) / rms


def _b_leaves(x):
    if isinstance(x, (tuple, list)):
        return [v for part in x for v in _b_leaves(part)]
    return [x]


def _b_pair(torch, label, fn, arrays, grad=(), rows=None, cpu_arrays=None,
            phase="B1", tol=None):
    """``fn`` on the CPU and on the card on the same arrays: every float
    output within ``tol`` (default B_TOL) of the CPU result's rms, every
    integer output equal; then the gradients of ``Σ out · c`` (its first
    output) for the arrays in ``grad``.  ``rows`` / ``cpu_arrays``: the
    CPU computes only the output rows ``rows`` (from ``cpu_arrays``), the
    card all of them.  ``phase`` labels the log line."""
    tol = B_TOL if tol is None else tol
    cpu = [a.detach().clone().requires_grad_(i in grad) for i, a in
           enumerate(cpu_arrays or arrays)]
    dev = [a.detach().to(DEVICE, copy=True).requires_grad_(i in grad)
           for i, a in enumerate(arrays)]
    out_c = fn(*cpu)
    out_d = fn(*dev)
    torch.cuda.synchronize()
    errs = []
    for c, d in zip(_b_leaves(out_c), _b_leaves(out_d)):
        if rows is not None:
            d = d[rows.to(d.device)]
        if c.is_floating_point():
            errs.append(_b_err(torch, d, c))
        else:
            assert torch.equal(d.cpu(), c), (label, "indices differ")
    err = max(errs) if errs else 0.0
    gerr = 0.0
    if grad and rows is None:
        pc, pd = _b_leaves(out_c)[0], _b_leaves(out_d)[0]
        cot = torch.randn(pc.shape, generator=torch.Generator().manual_seed(
            SEED + 7)).to(pc.dtype)
        gc = torch.autograd.grad((pc * cot).sum(), [cpu[i] for i in grad])
        gd = torch.autograd.grad((pd * cot.to(DEVICE)).sum(),
                                 [dev[i] for i in grad])
        gerr = max(_b_err(torch, d, c) for c, d in zip(gc, gd))
    assert err <= tol and gerr <= tol, (label, err, gerr)
    log(f"{phase} {label}: card vs CPU {err:.2e} x rms, gradients "
        f"{gerr:.2e} x rms (tol {tol:.0e})")
    return {"max_err": err, "grad_err": gerr}


def _b_boxes(torch, gen, n, w, h, lo=0.02, hi=0.3):
    """``n`` seeded pixel boxes inside a ``w x h`` image."""
    xy = torch.rand((n, 2), generator=gen) * torch.tensor([w, h]) * 0.8
    wh = (lo + (hi - lo) * torch.rand((n, 2), generator=gen)) \
        * torch.tensor([w, h])
    return torch.cat([xy, torch.minimum(xy + wh, torch.tensor(
        [w - 1.0, h - 1.0]))], 1)


def _sweep_inputs(torch, gen, instances, k, w, h):
    """The sweep's inputs as NMS builds them: per instance, k seeded boxes
    (in overlapping clusters) sorted by a seeded score, their IoU
    matrix."""
    import paddle_tpu_torch.nn.functional as F

    base = _b_boxes(torch, gen, instances * k // 4, w, h).reshape(
        instances, k // 4, 4)
    jit = (torch.rand((instances, k // 4, 4, 4), generator=gen) - 0.5) * 8
    boxes = (base[:, :, None, :] + jit).reshape(instances, k, 4)
    boxes = torch.cat([boxes[..., :2], torch.maximum(
        boxes[..., 2:], boxes[..., :2] + 1)], -1).to(DEVICE)
    scores = torch.rand((instances, k), generator=gen).to(DEVICE)
    s, order = torch.sort(scores, dim=1, descending=True, stable=True)
    sb = torch.gather(boxes, 1, order[..., None].expand(instances, k, 4))
    return F.iou_similarity(sb, sb, False), s


def _sweep_thresholds(torch, keep, thr, eta):
    """The threshold each candidate of the plain loop was decided against:
    ``thr`` (float32), times ``eta`` after each kept box while above 0.5,
    from the loop's own keep mask ``[B, k]``."""
    keep = keep.cpu()
    B, k = keep.shape
    t = torch.empty((B, k), dtype=torch.float32)
    cur = torch.full((B,), float(thr), dtype=torch.float32)
    for i in range(k):
        t[:, i] = cur
        if eta < 1.0:
            cur = torch.where(keep[:, i] & (cur > 0.5), cur * eta, cur)
    return t


def _sweep_check(torch, label, iou, s, thr, eta):
    """The kernel against the plain loop on the card, on one IoU matrix:
    masks equal, or every differing decision's deciding quantity, the
    largest IoU with a box the loop kept before it, within 1e-5 of the
    threshold the loop held then (a candidate with no kept box before it
    cannot differ).  Returns the count of differing decisions, the kept
    count and the largest such distance."""
    from paddle_tpu_torch.ops import nms_sweep, nms_sweep_ref

    t0 = time.monotonic()
    got = nms_sweep(iou, s, thr, eta)
    torch.cuda.synchronize()
    want = nms_sweep_ref(iou, s, thr, eta)
    torch.cuda.synchronize()
    diff = got != want
    worst = 0.0
    if bool(diff.any()):
        t_at = _sweep_thresholds(torch, want, thr, eta)
        for b, i in diff.nonzero().tolist():
            kept = want[b, :i]
            d = abs(float(iou[b, i, :i][kept].max()) - float(t_at[b, i])) \
                if bool(kept.any()) else float("inf")
            log(f"B1 sweep {label}: instance {b} candidate {i} differs; "
                f"its largest IoU with a kept box is {d:.3e} from the "
                f"threshold {float(t_at[b, i])}")
            worst = max(worst, d)
    assert worst <= 1e-5, (label, worst)
    log(f"B1 sweep {label} [{iou.shape[0]} x {iou.shape[1]}] thr {thr} eta "
        f"{eta}: kernel = plain loop ({int(diff.sum())} decisions differ), "
        f"{int(want.sum())} kept; both in {time.monotonic() - t0:.1f}s")
    return {"differ": int(diff.sum()), "kept": int(want.sum()),
            "worst_distance": worst}


def detection_ops_card_vs_cpu(torch):
    """Phase B1: every new op on the card against the port's CPU result on
    one seeded float32 input, forward and (where JAX differentiates)
    backward, at SSD300's, YOLOv3-608's, B2's C4 map's and the DCN res5
    shapes; then the sweep kernel against its plain loop at k = 12000 and
    80 classes x 1000; its timing."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.ops import nms_sweep, nms_sweep_ref

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    out, seed = {}, SEED + 1000
    # SSD300: the six maps' priors (8732) and the multibox loss
    img = torch.zeros(1, 3, 300, 300)

    def ssd_priors(im):
        boxes = [F.prior_box(torch.zeros(1, c, s, s, device=im.device), im,
                             [B_SSD["min_sizes"][i]],
                             [B_SSD["max_sizes"][i]],
                             B_SSD["aspect_ratios"][i], flip=True, clip=True,
                             steps=[B_SSD["steps"][i]] * 2)
                 for i, (c, s) in enumerate(B_SSD_MAPS)]
        return (torch.cat([b.reshape(-1, 4) for b, _ in boxes]),
                torch.cat([v.reshape(-1, 4) for _, v in boxes]))

    out["ssd300_prior_box"] = _b_pair(torch, "prior_box SSD300 x 6 maps",
                                      ssd_priors, [img])
    prior, pvar = ssd_priors(img)
    P = prior.shape[0]
    assert P == 8732, P
    g = gen(seed)
    loc = torch.randn((B_SSD_B, P, 4), generator=g) * 0.2
    conf = torch.randn((B_SSD_B, P, 21), generator=g)
    gt = _b_boxes(torch, g, B_SSD_B * B_GT, 1.0, 1.0, 0.05, 0.5).reshape(
        B_SSD_B, B_GT, 4)
    gt[:, 15:] = 0                                     # padding rows
    lab = torch.randint(1, 21, (B_SSD_B, B_GT, 1), generator=g)
    out["ssd300_ssd_loss"] = _b_pair(
        torch, f"ssd_loss [{B_SSD_B}, 8732, 21] G={B_GT}",
        lambda l, c, gg, lb, p, v: F.ssd_loss(l, c, gg, lb, p, v),
        [loc, conf, gt, lab, prior, pvar], grad=(0, 1))
    # YOLOv3-608: the loss at its three scales and the box decode
    g = gen(seed + 1)
    ygt = torch.cat([0.1 + 0.8 * torch.rand((B_YOLO_B, B_YOLO_GT, 2),
                                            generator=g),
                     0.02 + 0.4 * torch.rand((B_YOLO_B, B_YOLO_GT, 2),
                                             generator=g)], -1)
    ygt[:, 40:] = 0
    ylab = torch.randint(0, 80, (B_YOLO_B, B_YOLO_GT), generator=g)
    for mask, side, ratio in B_YOLO_SCALES:
        x = torch.randn((B_YOLO_B, 255, side, side), generator=g) * 0.5
        out[f"yolov3_loss_{side}"] = _b_pair(
            torch, f"yolov3_loss [{B_YOLO_B}, 255, {side}, {side}]",
            lambda xx, gg, ll, m=mask, r=ratio: F.yolov3_loss(
                xx, gg, ll, B_YOLO_ANCHORS, m, 80, 0.7, r),
            [x, ygt, ylab], grad=(0,))
    size = torch.full((B_YOLO_B, 2), 608, dtype=torch.int32)
    out["yolo_box_19"] = _b_pair(
        torch, "yolo_box [8, 255, 19, 19]", lambda xx, ss: F.yolo_box(
            xx, ss, B_YOLO_ANCHORS[12:], 80, 0.005, 32),
        [torch.randn((B_YOLO_B, 255, 19, 19), generator=g), size])
    # the RoI ops at B2's C4 map, R = 1024 (CPU reference on 128 of them,
    # then forward and backward on those 128 on both)
    g = gen(seed + 2)
    Hc, Wc = B_HW[0] // 16, B_HW[1] // 16
    fmap = torch.randn((B_IMAGES, 1024, Hc, Wc), generator=g)
    rois = _b_boxes(torch, g, B_ROIS, B_INFO[1], B_INFO[0], 0.02, 0.6)
    num = torch.tensor([B_ROIS // 2, B_ROIS // 2])
    sel = torch.arange(0, B_ROIS, B_ROIS // B_ROI_CHECK)
    sub = torch.tensor([B_ROI_CHECK // 2, B_ROI_CHECK // 2])
    roi_ops = {
        "roi_align": (lambda f, r, n: F.roi_align(f, r, rois_num=n, **B_ROI),
                      fmap, (0, 1)),
        "roi_pool": (lambda f, r, n: F.roi_pool(f, r, 14, 14, 1 / 16,
                                                rois_num=n), fmap, (0,)),
        "psroi_pool": (lambda f, r, n: F.psroi_pool(f, r, 64, 1 / 16, 4, 4,
                                                    rois_num=n), fmap, (0,))}
    for name, (fn, f, grad) in roi_ops.items():
        full = _b_pair(torch, f"{name} [2, 1024, {Hc}, {Wc}] R={B_ROIS} "
                       f"(CPU on {B_ROI_CHECK})", fn, [f, rois, num],
                       rows=sel, cpu_arrays=[f, rois[sel], sub])
        small = _b_pair(torch, f"{name} R={B_ROI_CHECK} forward + backward",
                        fn, [f, rois[sel], sub], grad=grad)
        out[name] = {"R1024_rows": full, f"R{B_ROI_CHECK}": small}
    # DCN at res5: [2, 512, 50, 84], 3 x 3, v1 and v2
    g = gen(seed + 3)
    x = torch.randn((B_IMAGES, 512, Hc, Wc), generator=g)
    off = torch.randn((B_IMAGES, 18, Hc, Wc), generator=g) * 2.0
    w = torch.randn((512, 512, 3, 3), generator=g) * 0.02
    m = torch.rand((B_IMAGES, 9, Hc, Wc), generator=g)
    out["deform_conv2d_v1"] = _b_pair(
        torch, f"deform_conv2d v1 [2, 512, {Hc}, {Wc}] 3x3",
        lambda a, o, ww: F.deform_conv2d(a, o, ww, padding=1), [x, off, w],
        grad=(0, 1, 2))
    out["deform_conv2d_v2"] = _b_pair(
        torch, f"deform_conv2d v2 [2, 512, {Hc}, {Wc}] 3x3",
        lambda a, o, ww, mm: F.deform_conv2d(a, o, ww, padding=1, mask=mm),
        [x, off, w, m], grad=(0, 1, 2, 3))
    # the roi_extra ops and matrix / locality-aware NMS at the JAX tests'
    # shapes
    g = gen(seed + 4)
    fx = torch.randn((2, 18, 10, 12), generator=g)
    r5 = _b_boxes(torch, g, 5, 20.0, 18.0, 0.1, 0.5)
    n5 = torch.tensor([2, 3])
    tr = torch.randn((5, 4, 3, 3), generator=g) * 0.5
    quads = torch.tensor([[1, 1, 9, 2, 10, 8, 2, 7], [3, 3, 7, 3, 7, 7, 3, 7],
                          [0, 0, 20, 0, 20, 4, 0, 4],
                          [2, 5, 6, 1, 10, 5, 6, 9]], dtype=torch.float32)
    for name, fn, arrays, grad in (
            ("prroi_pool", lambda a, r, n: F.prroi_pool(
                a, r, 0.5, 3, 2, batch_roi_nums=n), [fx, r5, n5], (0, 1)),
            ("deformable_roi_pooling", lambda a, r, t, n:
             F.deformable_roi_pooling(a, r, t, spatial_scale=0.5,
                                      group_size=(3, 3), pooled_height=3,
                                      pooled_width=3, sample_per_part=2,
                                      position_sensitive=True, rois_num=n),
             [fx, r5, tr, n5], (0, 2)),
            ("roi_perspective_transform", lambda a, r, n:
             F.roi_perspective_transform(a, r, 5, 6, 1.0, rois_num=n)[0],
             [fx, quads, torch.tensor([2, 2])], (0,)),
            ("polygon_box_transform", F.polygon_box_transform, [fx], (0,))):
        out[name] = _b_pair(torch, name, fn, arrays, grad=grad)
    nb = torch.stack([_b_boxes(torch, g, 16, 1.0, 1.0) for _ in range(2)])
    out["matrix_nms"] = _b_pair(
        torch, "matrix_nms [2, 3, 16]", lambda b, s: F.matrix_nms(
            b, s, 0.1, 0.05, 12, 20, return_index=True,
            return_rois_num=True), [nb, torch.rand((2, 3, 16), generator=g)],
        grad=(0, 1))
    out["locality_aware_nms"] = _b_pair(
        torch, "locality_aware_nms [2, 1, 16]", lambda b, s:
        F.locality_aware_nms(b, s, 0.2, -1, 8, 0.4),
        [nb, torch.rand((2, 1, 16), generator=g)])
    # the sweep kernel against its plain loop
    sweeps = {}
    iou, s = _sweep_inputs(torch, gen(seed + 5), B_IMAGES, 12000,
                           B_INFO[1], B_INFO[0])
    for thr, eta in ((0.7, 1.0), (0.95, 0.9)):
        sweeps[f"nms k=12000 eta={eta}"] = _sweep_check(
            torch, "nms k=12000", iou, s, thr, eta)
    # timing at the proposals' shape (two images, k = 12000)
    want = nms_sweep_ref(iou, s, 0.7, 1.0)
    kb = (torch.cumsum(want.long(), 1) - want.long())[torch.isfinite(s)]
    nbytes = 4 * int(kb.sum()) + s.numel() * 5
    ms = time_ms(torch, lambda a, b: nms_sweep(a, b, 0.7, 1.0), [(iou, s)],
                 10)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    nms_sweep_ref(iou, s, 0.7, 1.0)
    t1.record()
    torch.cuda.synchronize()
    timing = {"ms": ms, "plain_ms": t0.elapsed_time(t1),
              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes", "library_ms": None,
              "bound_bytes": nbytes, "shape": [B_IMAGES, 12000]}
    del iou, s
    iou, s = _sweep_inputs(torch, gen(seed + 6), 80, 1000, 1.0, 1.0)
    sweeps["multiclass_nms 80 x 1000"] = _sweep_check(
        torch, "multiclass_nms 80 classes x 1000", iou, s, 0.5, 1.0)
    del iou, s
    worst = max(v["max_err"] for v in _b_flat(out))
    log(f"B1: {len(_b_flat(out))} op checks card vs CPU, largest error "
        f"{worst:.2e} x rms (tol {B_TOL:.0e}); sweep kernel {timing['ms']:.3f}"
        f" ms at [2, 12000] beside the plain loop's {timing['plain_ms']:.1f} "
        f"ms and its {timing['bound_ms']:.4f} ms bound")
    return {"ops": out, "sweeps": sweeps, "sweep_timing": timing,
            "max_err": worst, "tol": B_TOL}


def _b_flat(d):
    return [v for v in d.values() if "max_err" in v] + [
        w for v in d.values() if "max_err" not in v for w in v.values()]


def detector(torch):
    """Faster R-CNN R50-C4 (Detectron / PaddleDetection faster_rcnn_r50_1x)
    on the port: ResNet-50 NHWC with the space-to-depth stem, bf16, its
    layers 1-3 the C4 backbone and layer4 (res5) the RoI head; the RPN's
    3 x 3 conv (1024 → 1024) and 1 x 1 heads (15 anchors: objectness,
    deltas); the 81-class and class-agnostic 4-delta fcs.  Random weights
    from the seed."""
    import paddle_tpu_torch as ptt

    nn = ptt.nn
    ptt.seed(SEED)

    class FasterRCNN(nn.Layer):
        def __init__(self):
            super().__init__()
            self.backbone = ptt.vision.models.resnet50(
                data_format="NHWC", stem_space_to_depth=True, num_classes=0,
                with_pool=False, device="cpu",
                generator=torch.Generator().manual_seed(SEED))
            A = len(B_ANCHORS["anchor_sizes"]) * len(
                B_ANCHORS["aspect_ratios"])
            self.rpn_conv = nn.Conv2D(1024, 1024, 3, padding=1,
                                      data_format="NHWC")
            self.rpn_cls = nn.Conv2D(1024, A, 1, data_format="NHWC")
            self.rpn_box = nn.Conv2D(1024, 4 * A, 1, data_format="NHWC")
            self.cls_fc = nn.Linear(2048, B_CLASSES)
            self.box_fc = nn.Linear(2048, 4)
            # Detectron's init of the heads: normal, std 0.01 (the box fc
            # 0.001), zero bias
            g = torch.Generator().manual_seed(SEED + 1101)
            for layer, std in ((self.rpn_conv, 0.01), (self.rpn_cls, 0.01),
                               (self.rpn_box, 0.01), (self.cls_fc, 0.01),
                               (self.box_fc, 0.001)):
                with torch.no_grad():
                    layer.weight.copy_(torch.randn(
                        layer.weight.shape, generator=g) * std)
                    layer.bias.zero_()

        def c4(self, x):
            net = self.backbone
            x = net.relu(net.bn1(net._stem_s2d(x)))
            return net.layer3(net.layer2(net.layer1(net.maxpool(x))))

        def rpn(self, feat):
            t = torch.relu(self.rpn_conv(feat))
            return self.rpn_cls(t), self.rpn_box(t)

        def head(self, pooled):
            x = self.backbone.layer4(pooled).mean((1, 2))
            return self.cls_fc(x).float(), self.box_fc(x).float()

    return FasterRCNN().to(DEVICE).astype("bfloat16")


def detection_batch(torch):
    """B2's seeded batch: 2 images 800 x 1344 (NHWC, bf16), im_info (800,
    1333, 1), 20 ground-truth boxes an image of 16-512 px, classes
    1-80."""
    g = torch.Generator().manual_seed(SEED + 1100)
    images = (torch.rand((B_IMAGES,) + B_HW + (3,), generator=g) * 2 - 1)
    ih, iw = B_INFO[0], B_INFO[1]
    side = 16 + 496 * torch.rand((B_IMAGES, B_GT, 2), generator=g)
    xy = torch.rand((B_IMAGES, B_GT, 2), generator=g) * (
        torch.tensor([iw, ih]) - side)
    gt = torch.cat([xy, xy + side - 1], -1)
    cls = torch.randint(1, B_CLASSES, (B_IMAGES, B_GT), generator=g,
                        dtype=torch.int32)
    info = torch.tensor([list(B_INFO)] * B_IMAGES)
    return (images.to(DEVICE, torch.bfloat16), gt.to(DEVICE), cls.to(DEVICE),
            torch.zeros((B_IMAGES, B_GT), dtype=torch.int32,
                        device=DEVICE), info.to(DEVICE))


def _smooth_l1(d, w, sigma=1.0):
    """PaddleDetection's smooth_l1 (``sigma``) of ``d`` weighted by ``w``."""
    s2 = sigma * sigma
    a = d.abs()
    return (w * (a.lt(1.0 / s2).float() * 0.5 * s2 * d * d
                 + a.ge(1.0 / s2).float() * (a - 0.5 / s2))).sum()


def detection_forward(torch, det, batch, anchors, var, use_random=True,
                      gen=None, mark=lambda name: None, keep=None):
    """One training forward of B2: backbone, RPN targets and losses,
    proposals, RCNN sampling, RoI Align, head and its losses.  ``mark``
    closes each stage; ``keep`` (a dict) receives the stages' outputs."""
    import paddle_tpu_torch.nn.functional as F

    images, gt, cls, crowd, info = batch
    feat = det.c4(images)                                  # [N, 50, 84, 1024]
    obj, dl = det.rpn(feat)
    N, H, W, A = obj.shape
    M = H * W * A
    cls_logits = obj.float().reshape(N, M, 1)
    bbox_pred = dl.float().reshape(N, M, 4)
    mark("backbone")
    pred_s, pred_l, lbl, tgt, inw = F.rpn_target_assign(
        bbox_pred, cls_logits, anchors.reshape(-1, 4), var.reshape(-1, 4),
        gt, crowd, info, use_random=use_random, key=gen, **B_RPN)
    valid = (lbl >= 0).float()
    rpn_cls = (valid * F.binary_cross_entropy_with_logits(
        pred_s, lbl.float().clamp_min(0), reduction="none")).sum() \
        / valid.sum().clamp_min(1.0)
    rpn_reg = _smooth_l1(pred_l - tgt, inw, 3.0) / valid.sum().clamp_min(1.0)
    mark("rpn_targets")
    with torch.no_grad():
        rois, probs, nums = F.generate_proposals(
            torch.sigmoid(cls_logits).reshape(N, H, W, A).permute(0, 3, 1, 2),
            bbox_pred.reshape(N, H, W, 4 * A).permute(0, 3, 1, 2), info,
            anchors, var, return_rois_num=True, **B_TRAIN_PROPOSALS)
    mark("proposals")
    s_rois, labels, btgt, binw, _ = F.generate_proposal_labels(
        rois, cls, crowd, gt, info, rois_num=nums, use_random=use_random,
        key=gen, **B_SAMPLING)
    mark("sampling")
    per_im = B_SAMPLING["batch_size_per_im"]
    pooled = F.roi_align(feat.permute(0, 3, 1, 2), s_rois,
                         rois_num=torch.full((N,), per_im, device=DEVICE),
                         **B_ROI)                          # [R, C, 14, 14]
    mark("roi_align")
    logits, deltas = det.head(pooled.permute(0, 2, 3, 1))
    lab = labels.reshape(-1).long()
    rcnn_cls = F.cross_entropy(logits, lab, ignore_index=-1,
                               reduction="mean")
    rcnn_reg = _smooth_l1(deltas - btgt[:, 4:8], binw[:, 4:8]) \
        / (lab >= 0).sum().clamp_min(1)
    loss = rpn_cls + rpn_reg + rcnn_cls + rcnn_reg
    mark("head")
    if keep is not None:
        keep.update(cls_logits=cls_logits.detach(),
                    bbox_pred=bbox_pred.detach(), rpn=(pred_s, pred_l, lbl,
                                                       tgt, inw),
                    proposals=(rois, probs, nums),
                    sampled=(s_rois, labels, btgt, binw))
    return loss, [float(v.detach())
                  for v in (rpn_cls, rpn_reg, rcnn_cls, rcnn_reg)]


def _b_close(torch, label, got, want, scale):
    """Equal indices; floats within 1e-4 of ``scale``."""
    for i, (g, w) in enumerate(zip(_b_leaves(got), _b_leaves(want))):
        g = g.detach().cpu()
        if w.is_floating_point():
            err = float((g.double() - w.double()).abs().max()) \
                if w.numel() else 0.0
            assert err <= 1e-4 * scale, (label, i, err)
        else:
            assert torch.equal(g, w), (label, i)


def detection_cpu_route(torch, keep, anchors, var, batch):
    """B2's check step: RPN targets, proposals and RCNN sampling of the
    card's RPN outputs recomputed on the CPU (use_random=False), held to
    the card's: indices and counts equal, boxes within 1e-4 of their
    scale, targets within 1e-4."""
    import paddle_tpu_torch.nn.functional as F

    gt, cls, crowd, info = [t.cpu() for t in batch[1:]]
    cl, bp = keep["cls_logits"].cpu(), keep["bbox_pred"].cpu()
    anchors, var = anchors.cpu(), var.cpu()
    N = cl.shape[0]
    H, W = B_HW[0] // 16, B_HW[1] // 16
    A = anchors.shape[2]
    rpn = F.rpn_target_assign(bp, cl, anchors.reshape(-1, 4),
                              var.reshape(-1, 4), gt, crowd, info,
                              use_random=False, **B_RPN)
    _b_close(torch, "rpn targets", keep["rpn"], rpn, 1.0)
    props = F.generate_proposals(
        torch.sigmoid(cl).reshape(N, H, W, A).permute(0, 3, 1, 2),
        bp.reshape(N, H, W, 4 * A).permute(0, 3, 1, 2), info, anchors, var,
        return_rois_num=True, **B_TRAIN_PROPOSALS)
    _b_close(torch, "proposals", keep["proposals"], props, B_INFO[1])
    sampled = F.generate_proposal_labels(
        props[0], cls, crowd, gt, info, rois_num=props[2], use_random=False,
        **B_SAMPLING)[:4]
    _b_close(torch, "sampled rois", keep["sampled"][0], sampled[0],
             B_INFO[1])
    _b_close(torch, "labels, targets, weights", keep["sampled"][1:],
             sampled[1:], 1.0)
    nums = props[2].tolist()
    labels = sampled[1].reshape(-1)
    return {"rois_num": nums, "fg": int((labels > 0).sum()),
            "bg": int((labels == 0).sum()),
            "rpn_fg": int((rpn[2] == 1).sum()),
            "rpn_sampled": int((rpn[2] >= 0).sum())}


@contextlib.contextmanager
def recording_resnet_kernels(calls):
    """While open, every launch of kernels 7 and 8 appends ``(name,
    inputs, outputs)`` to ``calls``, copied at the launch (the launchers
    are wrapped; the wrappers and their counters stay as they are)."""
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fcb

    stats, apply = fcb._stats_kernel, fcb._apply_kernel

    def copy(ts):
        return tuple(None if t is None else t.detach().clone() for t in ts)

    def rec_stats(x, w, *args, **kwargs):
        out = stats(x, w, *args, **kwargs)
        calls.append(("conv1x1_bn_stats", copy((x, w)), copy(out)))
        return out

    def rec_apply(y, scale, shift, residual, *args, **kwargs):
        out = apply(y, scale, shift, residual, *args, **kwargs)
        calls.append(("bn_apply_relu", copy((y, scale, shift, residual)),
                      copy((out,))))
        return out

    fcb._stats_kernel, fcb._apply_kernel = rec_stats, rec_apply
    try:
        yield calls
    finally:
        fcb._stats_kernel, fcb._apply_kernel = stats, apply


def check_path_resnet_kernels(torch, calls, label):
    """Kernels 7 and 8 at every launch a path made (``calls`` from
    :func:`recording_resnet_kernels`), their outputs against their plain
    versions on the same inputs at R1's tolerances: kernel 7 by
    :func:`stats_tolerance`, kernel 8 bit-equal.  Returns, per kernel, a
    row per shape: calls and largest errors."""
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fcb

    rows = {"conv1x1_bn_stats": {}, "bn_apply_relu": {}}
    for name, args, out in calls:
        if name == "conv1x1_bn_stats":
            (x, w), (y, s, q) = args, out
            (M, K), N = x.shape, w.shape[1]
            dtype = str(x.dtype).replace("torch.", "")
            y0, s0, q0 = fcb.conv1x1_bn_stats_ref(x, w)
            yf_abs = (x.float() @ w.float()).abs().sum(0)
            errs = stats_tolerance(torch, y, y0, s, s0, q, q0, yf_abs, dtype)
            shape = f"{dtype} [{M}, {K}] @ [{K}, {N}]"
        else:
            (y, scale, shift, res), (got,) = args, out
            want = fcb.bn_apply_relu_ref(y, scale, shift, res)
            assert torch.equal(got, want), (
                f"{label}: bn_apply_relu differs from plain at "
                f"{list(y.shape)}: "
                f"{float((got.float() - want.float()).abs().max())}")
            errs = (0.0, 0.0, 0.0)
            shape = (f"{str(y.dtype).replace('torch.', '')} {list(y.shape)}"
                     f"{' + residual' if res is not None else ''}")
        row = rows[name].setdefault(shape, {
            "shape": shape, "calls": 0, "max_abs_err": 0.0,
            **({"sum_err": 0.0, "sumsq_err": 0.0}
               if name == "conv1x1_bn_stats" else {})})
        row["calls"] += 1
        for key, e in zip(("max_abs_err", "sum_err", "sumsq_err"), errs):
            if key in row:
                row[key] = max(row[key], e)
    for name, by_shape in rows.items():
        log(f"{label}: kernel {name} at the {len(by_shape)} shapes the path "
            f"gave it, on its inputs: "
            + "; ".join(f"{r['shape']} x {r['calls']}: max_abs_err "
                        f"{r['max_abs_err']:.3e}"
                        + (f", sum err {r['sum_err']:.2e}, sumsq err "
                           f"{r['sumsq_err']:.2e}" if "sum_err" in r else "")
                        for r in by_shape.values())
            + (" (rtol 2**-7, atol 1e-5 x max|y|; sums <= 3e-5)"
               if name == "conv1x1_bn_stats" else " (bit-equal)") + "; ok")
    return {name: list(by_shape.values()) for name, by_shape in rows.items()}


def train_faster_rcnn(torch, gpu):
    """Phase B2: Faster R-CNN R50-C4 training on 2 x 800 x 1344 at
    faster_rcnn_r50_1x's settings with the departures ``B_CONFIG`` names:
    one warm-up and B_STEPS timed steps of Momentum(0.9, multi_precision,
    weight_decay 1e-4) on the config's lr, linearly scaled and warming up,
    CUDA events around each stage, kernels 7-8 and the sweep counted, the
    loss held below ``B_LOSS_RISE`` x the warm-up step's; then a check
    step with use_random=False against the CPU route, kernels 7 and 8 held
    to their plain versions at each call it made."""
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.ops import bn_apply_relu, conv1x1_bn_stats, nms_sweep

    t0 = time.monotonic()
    det = detector(torch)
    batch = detection_batch(torch)
    Hc, Wc = B_HW[0] // 16, B_HW[1] // 16
    anchors, var = F.anchor_generator(
        torch.zeros(1, 1, Hc, Wc, device=DEVICE), **B_ANCHORS)
    n_anchors = anchors.shape[:3].numel()   # 50 x 84 x 15 = 63000
    assert n_anchors == Hc * Wc * 15, anchors.shape
    lr = ptt.optimizer.lr.LinearWarmup(B_LR, B_LR_WARMUP, B_LR / 3, B_LR)
    opt = ptt.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                 parameters=det.parameters(),
                                 multi_precision=True, weight_decay=1e-4)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    log(f"B2 Faster R-CNN R50-C4: {sum(p.numel() for p in det.parameters())}"
        f" parameters (bf16), {B_IMAGES} x {B_HW[0]} x {B_HW[1]}, "
        f"{n_anchors} anchors an image, built in "
        f"{time.monotonic() - t0:.1f}s")

    def step(mark=lambda name: None, use_random=True, keep=None):
        loss, parts = detection_forward(torch, det, batch, anchors, var,
                                        use_random, gen, mark, keep)
        loss.backward()
        mark("backward")
        opt.step()
        opt.clear_grad()
        lr.step()
        mark("optimizer")
        return parts

    warm = [step() for _ in range(B_WARMUP)]
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = (conv1x1_bn_stats, bn_apply_relu, nms_sweep)
    for c in counters:
        c.launches = 0
    stage_ms = {s: 0.0 for s in B_STAGES}
    per_step, losses, walls = [], [], []
    for _ in range(B_STEPS):
        before = [c.launches for c in counters]
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()
        names = []

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            names.append(name)

        w0 = time.monotonic()
        losses.append(step(mark))
        torch.cuda.synchronize()
        walls.append(time.monotonic() - w0)
        for name, a, b in zip(names, events, events[1:]):
            stage_ms[name] += a.elapsed_time(b) / B_STEPS
        per_step.append([c.launches - b for c, b in zip(counters, before)])
    peak = torch.cuda.max_memory_allocated()
    k7, k8, sweep = (sum(s[i] for s in per_step) for i in range(3))
    for parts in warm + losses:
        assert all(math.isfinite(v) for v in parts), (warm, losses)
    rise = max(sum(p) for p in losses) / sum(warm[-1])
    assert rise <= B_LOSS_RISE, (warm, losses)
    assert all(s[0] == 16 and s[1] == 16 for s in per_step), per_step
    assert all(s[2] == 1 for s in per_step), per_step
    step_ms = sum(walls) / B_STEPS * 1e3
    log(f"B2 losses (rpn cls, rpn reg, rcnn cls, rcnn reg), warm-up then "
        f"the timed steps: {[[round(v, 4) for v in p] for p in warm]} "
        f"{[[round(v, 4) for v in p] for p in losses]}; the largest total "
        f"{rise:.3f} x the warm-up's (<= {B_LOSS_RISE}); lr "
        f"{opt.get_lr():.3e} after them")
    log(f"B2 kernel launches a step (conv1x1_bn_stats, bn_apply_relu, "
        f"nms_sweep): {per_step}")
    log(f"B2 Faster R-CNN R50-C4 training[{gpu}]: {step_ms:.1f} ms a step, "
        f"{B_IMAGES * 1e3 / step_ms:.2f} img/s, stages (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stage_ms.items())
        + f"; peak device memory {peak / 2**20:.0f} MiB")
    # the check step: use_random=False, the CPU route on the same tensors;
    # kernels 7 and 8 at every call it makes against their plain versions
    keep, calls = {}, []
    with recording_resnet_kernels(calls):
        step(use_random=False, keep=keep)
    torch.cuda.synchronize()
    assert [n for n, _, _ in calls].count("conv1x1_bn_stats") == 16 \
        and [n for n, _, _ in calls].count("bn_apply_relu") == 16, \
        [n for n, _, _ in calls]
    path_checks = check_path_resnet_kernels(torch, calls, "B2 check step")
    del calls
    t1 = time.monotonic()
    check = detection_cpu_route(torch, keep, anchors, var, batch)
    log(f"B2 check step (use_random=False): RPN targets, proposals "
        f"{check['rois_num']}, sampled RoIs ({check['fg']} fg, {check['bg']}"
        f" bg), labels and targets equal to the CPU route (boxes within "
        f"1e-4 of their scale; CPU route {time.monotonic() - t1:.1f}s)")
    del keep
    del det, opt
    return {"batch": batch, "anchors": anchors, "var": var,
            "result": {
                "step_ms": step_ms, "img_per_s": B_IMAGES * 1e3 / step_ms,
                "stage_ms": stage_ms, "losses": losses,
                "warmup_losses": warm, "loss_rise": rise,
                "launches_per_step": per_step, "peak_bytes": peak,
                "check_step": check, "kernel_path_checks": path_checks,
                "config": B_CONFIG}}


def infer_faster_rcnn(torch, gpu, batch, anchors, var):
    """Phase B3: inference in eval mode: test proposals (6000 / 1000),
    RoI Align and the head, box_coder(decode_center_size) and
    multiclass_nms(0.05, 0.5, keep_top_k 100); ms an image; the
    detections against the CPU route on the same tensors.  The detector
    is built afresh (the seed's weights), so B3 does not depend on B2's
    random sampling."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.ops import nms_sweep

    images, _, _, _, info = batch
    det = detector(torch)
    det.eval()

    def infer(keep=None):
        feat = det.c4(images)
        obj, dl = det.rpn(feat)
        N, H, W, A = obj.shape
        rois, _, nums = F.generate_proposals(
            torch.sigmoid(obj.float()).permute(0, 3, 1, 2),
            dl.float().reshape(N, H, W, 4 * A).permute(0, 3, 1, 2), info,
            anchors, var, return_rois_num=True, **B_TEST_PROPOSALS)
        K = rois.shape[1]
        pooled = F.roi_align(feat.permute(0, 3, 1, 2), rois.reshape(-1, 4),
                             rois_num=torch.full((N,), K, device=DEVICE),
                             **B_ROI)
        logits, deltas = det.head(pooled.permute(0, 2, 3, 1))
        probs = torch.softmax(logits, -1).reshape(N, K, -1)
        boxes = F.box_coder(rois.reshape(-1, 4), B_BOX_VAR,
                            deltas[:, None, :], "decode_center_size",
                            box_normalized=False, axis=1).reshape(N, K, 4)
        out = F.multiclass_nms(boxes, probs.transpose(1, 2),
                               return_num=True, **B_NMS)
        if keep is not None:
            keep.update(rois=rois, deltas=deltas, probs=probs, out=out)
        return out

    with torch.no_grad():
        infer()
        torch.cuda.synchronize()
        nms_sweep.launches = 0
        t0 = time.monotonic()
        for _ in range(B_STEPS):
            infer()
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) / B_STEPS * 1e3
        launches = nms_sweep.launches
        keep = {}
        dets, nums = infer(keep)
        torch.cuda.synchronize()
    del det
    rois, deltas, probs = (keep[k].cpu() for k in ("rois", "deltas",
                                                   "probs"))
    N, K = rois.shape[:2]
    boxes = F.box_coder(rois.reshape(-1, 4), B_BOX_VAR, deltas[:, None, :],
                        "decode_center_size", box_normalized=False,
                        axis=1).reshape(N, K, 4)
    want, want_n = F.multiclass_nms(boxes, probs.transpose(1, 2),
                                    return_num=True, **B_NMS)
    assert torch.equal(nums.cpu(), want_n), (nums, want_n)
    assert torch.equal(dets[..., 0].cpu(), want[..., 0])
    err = float((dets.cpu() - want).abs().max()) if want.numel() else 0.0
    assert err <= 1e-4 * B_INFO[1], err
    assert launches == 2 * B_STEPS, launches   # proposals + class NMS
    fg = probs[..., 1:]
    log(f"B3 class scores: max {float(fg.max()):.4f}, "
        f"{int((fg > B_NMS['score_threshold']).sum())} (RoI, class) pairs "
        f"above {B_NMS['score_threshold']}")
    log(f"B3 Faster R-CNN inference[{gpu}]: {ms / B_IMAGES:.1f} ms an image "
        f"({ms:.1f} ms for {B_IMAGES}); detections kept {nums.tolist()} "
        f"(keep_top_k {B_NMS['keep_top_k']}), equal to the CPU route "
        f"(labels and counts exact, boxes / scores within {err:.1e}); "
        f"{launches // B_STEPS} sweep launches a pass")
    return {"ms_per_image": ms / B_IMAGES, "kept": nums.tolist(),
            "max_abs_err_vs_cpu": err,
            "sweep_launches_per_pass": launches // B_STEPS}


def detection_static(torch, gpu):
    """Phase B4: a ``fluid.Program`` with ``multi_box_head`` over SSD300's
    six maps, ``deformable_conv``, ``fluid.layers.roi_align`` and
    ``multiclass_nms`` through ``Executor.run`` on the card, against the
    eager ops with the program's parameters (1e-5 of the result's rms;
    one device, the same kernels), and ``vision.ops.MultiBoxHead`` with
    the same parameters."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    import paddle_tpu_torch.nn.functional as F
    import paddle_tpu_torch.vision.ops as vops

    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    maps = [(f"m{i}", c, s) for i, (c, s) in enumerate(B_SSD_MAPS)]
    with fluid.program_guard(main, startup):
        feats = [fluid.data(n, [-1, c, s, s]) for n, c, s in maps]
        img = fluid.data("img", [-1, 3, 300, 300])
        locs, confs, boxes, var = L.multi_box_head(
            feats, img, base_size=300, num_classes=21,
            aspect_ratios=B_SSD["aspect_ratios"], min_ratio=20,
            max_ratio=90, steps=B_SSD["steps"], flip=True, clip=True,
            offset=0.5)
        x = fluid.data("x", [-1, 256, 38, 38])
        off = fluid.data("off", [-1, 18, 38, 38])
        msk = fluid.data("msk", [-1, 9, 38, 38])
        dcn = L.deformable_conv(x, off, msk, num_filters=256, filter_size=3,
                                padding=1)
        rois = fluid.data("rois", [-1, 4])
        pooled = L.roi_align(dcn, rois, 7, 7, 1 / 8, 2)
        scores = L.softmax(confs)
        dets = L.multiclass_nms(
            L.box_coder(boxes, var, locs, code_type="decode_center_size"),
            L.transpose(scores, [0, 2, 1]), 0.01, 200, 50, 0.45)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    rng = np.random.RandomState(SEED + 1200)
    feed = {n: rng.randn(2, c, s, s).astype(np.float32) for n, c, s in maps}
    feed.update(img=rng.randn(2, 3, 300, 300).astype(np.float32),
                x=rng.randn(2, 256, 38, 38).astype(np.float32),
                off=(rng.randn(2, 18, 38, 38) * 2).astype(np.float32),
                msk=rng.uniform(size=(2, 9, 38, 38)).astype(np.float32),
                rois=(np.sort(rng.uniform(0, 300, (64, 2, 2)), 1)
                      .transpose(0, 2, 1).reshape(64, 4)
                      .astype(np.float32)))
    outs = exe.run(main, feed=feed, fetch_list=[locs, confs, boxes, var,
                                                dcn, pooled, dets])
    scope = {k.split("_", 2)[2].rsplit("_", 1)[0]: v
             for k, v in main.scope.items()}
    t = {k: torch.from_numpy(v).to(DEVICE) for k, v in feed.items()}
    head = vops.MultiBoxHead([c for _, c, _ in maps], 300, 21,
                             B_SSD["aspect_ratios"], min_ratio=20,
                             max_ratio=90, steps=B_SSD["steps"], flip=True,
                             clip=True).to(DEVICE)
    with torch.no_grad():
        for i in range(len(maps)):
            for kind, convs in (("loc", head.loc_convs),
                                ("conf", head.conf_convs)):
                convs[i].weight.copy_(scope[f"mbox_{kind}{i}.weight"])
                convs[i].bias.copy_(scope[f"mbox_{kind}{i}.bias"])
        mb = head([t[n] for n, _, _ in maps], t["img"])
        ed = F.deform_conv2d(t["x"], t["off"],
                             scope["deformable_conv.weight"],
                             scope["deformable_conv.bias"], padding=1,
                             mask=t["msk"])
        ep = F.roi_align(ed, t["rois"], 7, 7, 1 / 8, 2)
        edets = F.multiclass_nms(
            F.box_coder(mb[2], mb[3], mb[0], "decode_center_size"),
            torch.softmax(mb[1], -1).transpose(1, 2), 0.01, 200, 50, 0.45)
    errs = {}
    for name, got, want in zip(
            ("mbox_locs", "mbox_confs", "boxes", "variances",
             "deformable_conv", "roi_align", "multiclass_nms"),
            outs, list(mb) + [ed, ep, edets]):
        got = torch.from_numpy(np.asarray(got))
        assert tuple(got.shape) == tuple(want.shape), (name, got.shape)
        errs[name] = _b_err(torch, got, want)
        assert errs[name] <= 1e-5, (name, errs[name])
    log(f"B4 static detection names through Executor.run[{gpu}]: "
        f"multi_box_head (SSD300's six maps, {outs[2].shape[0]} priors), "
        f"deformable_conv, roi_align, multiclass_nms equal the eager ops and"
        f" vision.ops.MultiBoxHead with the program's parameters: errors "
        f"{errs} x rms (tol 1e-5)")
    return {"errors": errs, "priors": int(outs[2].shape[0])}


def detection_phases(torch, gpu):
    """B1-B4, then the ``{"detection": ...}`` line; returns what the
    kernels line needs."""
    b1 = detection_ops_card_vs_cpu(torch)
    gc.collect()
    torch.cuda.empty_cache()
    b2 = train_faster_rcnn(torch, gpu)
    batch, anchors, var = b2["batch"], b2["anchors"], b2["var"]
    b2 = b2["result"]
    gc.collect()
    torch.cuda.empty_cache()
    b3 = infer_faster_rcnn(torch, gpu, batch, anchors, var)
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    b4 = detection_static(torch, gpu)
    log(json.dumps({"detection": {
        "device": gpu, "B1_ops_card_vs_cpu": b1, "B2_faster_rcnn_train": b2,
        "B3_faster_rcnn_infer": b3, "B4_static_names": b4}}, default=str))
    return {"B1": b1, "B2": b2, "B3": b3, "B4": b4}


# -- the sequence-tagging slice: SQ1-SQ4 ----------------------------------
SQ_TOL = 1e-4       # card vs CPU, float32: max |diff| / rms(CPU result)
SQ_TIE = 1e-5       # a differing Viterbi path: the CPU scores both within it
# SQ2: LAC's BiGRU-CRF (lexical_analysis nets.py) at its published widths
SQ2_VOCAB, SQ2_EMB, SQ2_HID, SQ2_TAGS = 20940, 128, 128, 57
SQ2_B, SQ2_T = 300, 64
SQ2_WARMUP, SQ2_STEPS, SQ2_WINDOW, SQ2_BATCHES = 2, 5, 10, 4
SQ2_CONFIG = ("LAC lexical_analysis nets.py: embedding(20940, 128), 2 x "
              "BiGRU (fc(3 x 128) -> dynamic_gru(128) each way), fc(57), "
              "linear_chain_crf + crf_decoding on a [59, 57] transition "
              "from fluid.layers.create_parameter, Adam(1e-3), batch 300 x "
              "max_seq_len 64; departures: the vocabulary 20940 is assumed "
              "to be word.dic's size, LAC's emb / crf learning rates are not "
              "applied (ParamAttr.learning_rate, ROADMAP C), the GRUs run "
              "over the padding (the dense form); seeded data")
# SQ3: a BERT-base CRF tagger at PaddleNLP msra_ner's shapes
SQ3_B, SQ3_S, SQ3_TAGS, SQ3_LR = 32, 128, 7, 2e-5
# three warm-up steps: Adam's third step from random weights overshoots
# (1.29x the first step's loss on the card and on the CPU alike, then
# falling), so the timed steps start after it
SQ3_WARMUP, SQ3_STEPS = 3, 10
SQ3_RISE = 1.25
SQ3_CONFIG = ("PaddleNLP msra_ner: max_seq_length 128, batch 32, 7 BIO tags, "
              "AdamW(2e-5, wd 0.01, multi_precision); BertModel(bert_base()) "
              "bf16 -> Linear(768, 7) -> linear_chain_crf (float32, [9, 7] "
              "transition); departures: vocabulary 30522 (bert_base's) for "
              "msra_ner's multilingual one, a CRF head for its softmax head, "
              "random weights, seeded tokens that name their tag's type")


def _sq_path_scores(torch, e, tr, path, ln):
    """The CPU score (float64) of each row's ``path`` under emissions
    ``e [B, T, D]`` and transition ``tr`` over its ``ln`` valid steps."""
    e, tr = e.detach().double().cpu(), tr.detach().double().cpu()
    path, ln = path.cpu(), ln.cpu()
    start, stop, trans = tr[0], tr[1], tr[2:]
    T = e.shape[1]
    mask = torch.arange(T)[None, :] < ln[:, None]
    emit = torch.gather(e, 2, path[..., None])[..., 0]
    s = start[path[:, 0]] + emit[:, 0]
    if T > 1:
        step = trans[path[:, :-1], path[:, 1:]] + emit[:, 1:]
        s = s + torch.where(mask[:, 1:], step, torch.zeros_like(step)).sum(1)
    last = torch.gather(path, 1, (ln - 1).clamp(min=0)[:, None])[:, 0]
    return s + stop[last]


def _sq_paths(torch, label, got, want, e, tr, ln):
    """Card paths against CPU paths: equal, or a differing row whose two
    paths the CPU scores within SQ_TIE relative of each other (a tie),
    each such row printed.  Returns the number of tied rows."""
    got, want = got.cpu(), want.cpu()
    rows = (got != want).any(1).nonzero().flatten()
    if len(rows):
        sg = _sq_path_scores(torch, e[rows], tr, got[rows], ln.cpu()[rows])
        sw = _sq_path_scores(torch, e[rows], tr, want[rows], ln.cpu()[rows])
        for r, a, b in zip(rows.tolist(), sg.tolist(), sw.tolist()):
            rel = abs(a - b) / max(abs(b), 1.0)
            log(f"SQ {label}: row {r}'s path differs card vs CPU; the CPU "
                f"scores them {a!r} / {b!r} (relative {rel:.2e}, tie rule "
                f"{SQ_TIE:.0e})")
            assert rel <= SQ_TIE, (label, r, a, b)
    return len(rows)


def _sq_lengths(torch, gen, B, T, lo=1):
    ln = torch.randint(lo, T + 1, (B,), generator=gen)
    ln[0], ln[1] = 1, T
    return ln


def _sq_crf_checks(torch, F, gen, B, T, D, label):
    e = torch.randn(B, T, D, generator=gen)
    tr = torch.randn(D + 2, D, generator=gen)
    y = torch.randint(0, D, (B, T), generator=gen)
    ln = _sq_lengths(torch, gen, B, T)
    nll = _b_pair(torch, f"linear_chain_crf {label} [{B}, {T}, {D}]",
                  F.linear_chain_crf, [e, tr, y, ln], grad=(0, 1),
                  phase="SQ1", tol=SQ_TOL)
    pd, sd = F.viterbi_decode(e.to(DEVICE), tr.to(DEVICE), ln.to(DEVICE))
    pc, sc = F.viterbi_decode(e, tr, ln)
    serr = _b_err(torch, sd, sc)
    assert serr <= SQ_TOL, (label, serr)
    ties = _sq_paths(torch, f"viterbi {label}", pd, pc, e, tr, ln)
    agree = F.crf_decoding(e.to(DEVICE), tr.to(DEVICE), label=y.to(DEVICE),
                           length=ln.to(DEVICE)).cpu()
    mask = torch.arange(T)[None, :] < ln[:, None]
    assert agree.dtype == torch.int64 and torch.equal(
        agree, torch.where(mask, (pd.cpu() == y).long(), 0)), label
    log(f"SQ1 viterbi / crf_decoding {label} [{B}, {T}, {D}]: scores "
        f"{serr:.2e} x rms, paths equal but {ties} tied rows; the "
        f"agreement mask = (path == label) within the lengths")
    return {"nll": nll, "score_err": serr, "tied_rows": ties}


def _sq_sequence_cases(torch, gen):
    """(label, fn, arrays, grad) of every sequence op at [300, 64, 128]."""
    from paddle_tpu_torch.nn import functional as F

    B, T, D = SQ2_B, SQ2_T, SQ2_EMB
    x = torch.randn(B, T, D, generator=gen)
    ln = _sq_lengths(torch, gen, B, T)
    ln2 = _sq_lengths(torch, gen, B, 32)
    ids = torch.randint(1, 9, (B, T), generator=gen)
    off = torch.randint(0, T - 16, (B,), generator=gen)
    idx = torch.randint(0, T, (B, 16), generator=gen)
    upd = torch.randn(B, 16, D, generator=gen)
    k = torch.randint(0, 17, (B,), generator=gen)
    cases = [(f"sequence_pool {p}", lambda x, ln, p=p: F.sequence_pool(
        x, p, pad_value=-7.0, lengths=ln), [x, ln], (0,))
        for p in ("sum", "average", "sqrt", "max", "first", "last")]
    cases += [
        ("sequence_first_step", F.sequence_first_step, [x, ln], (0,)),
        ("sequence_last_step", F.sequence_last_step, [x, ln], (0,)),
        ("sequence_softmax", lambda x, ln: F.sequence_softmax(
            x[..., 0], lengths=ln), [x, ln], (0,)),
        ("sequence_reverse", lambda x, ln: F.sequence_reverse(
            x, lengths=ln), [x, ln], (0,)),
        ("sequence_expand", lambda x, ln: F.sequence_expand(x[:, 0], ln),
         [x, ln], (0,)),
        ("sequence_expand_as", lambda x: F.sequence_expand_as(x[:, 0], x),
         [x], (0,)),
        ("sequence_enumerate", lambda i, ln: F.sequence_enumerate(
            i, 3, pad_value=-1, lengths=ln), [ids, ln], ()),
        ("sequence_pad extend", lambda x, ln: F.sequence_pad(
            x, -1.0, maxlen=T + 8, lengths=ln), [x, ln], (0,)),
        ("sequence_pad trim", lambda x, ln: F.sequence_pad(
            x, 0.5, maxlen=40, lengths=ln), [x, ln], (0,)),
        ("sequence_unpad", F.sequence_unpad, [x, ln], (0,)),
        ("sequence_slice", lambda x, o: F.sequence_slice(x, o, 16),
         [x, off], (0,)),
        ("sequence_scatter", lambda x, i, u, k: F.sequence_scatter(
            x, i, u, lengths=k), [x, idx, upd, k], (0, 2)),
        ("sequence_reshape", lambda x, ln: F.sequence_reshape(
            x, 64, lengths=ln), [x, ln], (0,)),
        ("sequence_concat", lambda x, ln, ln2: F.sequence_concat(
            [x, x[:, :32] * 2.0], lengths=[ln, ln2]), [x, ln, ln2], (0,)),
    ]
    return cases


def _sq_small_cases(torch, gen):
    """(label, fn, arrays, grad) of the extras ops and fluid.layers' resize
    / pad / crop / grid-sampling / beam-search / hash / similarity names
    at the CPU tests' shapes (beam search at 64 x 4 x 4)."""
    from paddle_tpu_torch.fluid import layers as L
    from paddle_tpu_torch.nn import functional as F

    def r(*shape):
        return torch.randn(*shape, generator=gen)

    cases = [
        ("add_position_encoding", lambda x: F.add_position_encoding(
            x, 0.5, 2.0), [r(2, 5, 8)], (0,)),
        ("affine_channel", lambda x, s, b: F.affine_channel(
            x, s, b, act="relu"), [r(2, 3, 4, 4), r(3), r(3)], (0, 1, 2)),
        ("bpr_loss", lambda x, y: F.bpr_loss(x, y),
         [r(5, 4), torch.tensor([[0], [3], [1], [1], [2]])], (0,)),
        ("rank_loss", lambda l, s, t: F.rank_loss(l, s, t),
         [torch.rand(3, 1, generator=gen), r(3, 1), r(3, 1)], (1, 2)),
        ("margin_rank_loss", lambda l, s, t: F.margin_rank_loss(
            l, s, t, margin=0.2), [torch.tensor([[1.0], [-1.0], [1.0]]),
                                   r(3, 1), r(3, 1)], (1, 2)),
        ("shuffle_channel", lambda x: F.shuffle_channel(x, 2),
         [r(2, 6, 3, 3)], (0,)),
        ("space_to_depth", lambda x: F.space_to_depth(x, 2),
         [r(2, 3, 4, 6)], (0,)),
        ("fsp_matrix", F.fsp_matrix, [r(2, 3, 4, 5), r(2, 4, 4, 5)], (0, 1)),
        ("continuous_value_model", lambda x: F.continuous_value_model(
            x.abs(), None, True), [r(4, 5)], (0,)),
        ("lrn", lambda x: F.lrn(x, n=5, k=2.0, alpha=1e-3),
         [r(2, 7, 3, 3)], (0,)),
        ("im2sequence", lambda x: F.im2sequence(
            x, filter_size=3, stride=2, padding=[1, 0, 2, 1]),
         [r(1, 2, 6, 5)], (0,)),
        ("adaptive_pool2d avg", lambda x: F.adaptive_pool2d(x, 3, "avg"),
         [r(2, 3, 7, 6)], (0,)),
        ("adaptive_pool3d max", lambda x: F.adaptive_pool3d(x, 2, "max"),
         [r(1, 2, 5, 4, 6)], (0,)),
        ("fill_constant_batch_size_like", lambda x:
         F.fill_constant_batch_size_like(x, [1, 4], "float32", 2.5),
         [r(3, 7)], ()),
        ("pad2d reflect", lambda x: L.pad2d(x, [1, 2, 2, 1], mode="reflect"),
         [r(2, 3, 4, 5)], (0,)),
        ("pad2d edge NHWC", lambda x: L.pad2d(
            x, [1, 1, 0, 2], mode="edge", data_format="NHWC"),
         [r(2, 4, 5, 3)], (0,)),
        ("image_resize bilinear", lambda x: L.image_resize(
            x, out_shape=[6, 7]), [r(2, 3, 4, 5)], (0,)),
        ("image_resize nearest", lambda x: L.image_resize(
            x, scale=2.0, resample="NEAREST"), [r(2, 3, 4, 5)], (0,)),
        ("resize_bilinear", lambda x: L.resize_bilinear(
            x, out_shape=[3, 9], align_corners=False, align_mode=0),
         [r(1, 2, 5, 5)], (0,)),
        ("resize_nearest", lambda x: L.resize_nearest(x, out_shape=[7, 3]),
         [r(1, 2, 5, 5)], (0,)),
        ("resize_linear", lambda x: L.resize_linear(x, out_shape=[9]),
         [r(2, 3, 5)], (0,)),
        ("resize_trilinear", lambda x: L.resize_trilinear(
            x, out_shape=[3, 4, 5]), [r(1, 2, 2, 3, 4)], (0,)),
        ("image_resize_short", lambda x: L.image_resize_short(x, 6),
         [r(1, 2, 4, 7)], (0,)),
        ("grid_sampler", L.grid_sampler,
         [r(2, 3, 5, 6), torch.rand(2, 4, 3, 2, generator=gen) * 2.2 - 1.1],
         (0, 1)),
        ("crop_tensor", lambda x: L.crop_tensor(
            x, shape=[2, 2, 3], offsets=[0, 1, 1]), [r(2, 4, 5)], (0,)),
        ("similarity_focus", lambda x: L.similarity_focus(x, 2, [1, 3]),
         [torch.rand(2, 3, 4, 5, generator=gen)], ()),
    ]
    # the 1.x beam search: 64 sentences x beam 4, K = 4, some beams done
    W, K, end = 4, 4, 9
    pre_ids = torch.randint(0, 8, (64 * W, 1), generator=gen)
    pre_ids[::7] = end
    pre = torch.randn(64 * W, 1, generator=gen)
    ids = torch.randint(0, 8, (64 * W, K), generator=gen)
    cases += [
        (f"beam_search accumulated={acc}", lambda a, b, c, d, acc=acc:
         L.beam_search(a, b, c, d, W, end, is_accumulated=acc,
                       return_parent_idx=True),
         [pre_ids, pre, ids, (torch.randn(64 * W, K, generator=gen) if acc
                              else torch.rand(64 * W, K, generator=gen))],
         ()) for acc in (True, False)]
    # hash over int64 keys spanning the full range: bit-equal
    keys = torch.randint(-2 ** 63, 2 ** 63 - 1, (1000, 4), generator=gen,
                         dtype=torch.int64)
    cases += [(f"hash size {m}", lambda k, m=m, n=n: L.hash(k, m, n),
               [keys], ()) for m, n in ((1000, 2), (2 ** 40 + 7, 1))]
    return cases


def tagging_ops_card_vs_cpu(torch):
    """Phase SQ1: every new op on the card against the port's CPU result
    on one seeded float32 input (1e-4 of the rms; indices and integers
    equal, Viterbi paths but for CPU-scored ties): the CRF at SQ2's and
    SQ3's shapes, the sequence ops at [300, 64, 128], the extras and
    fluid.layers' new names; the random ops' invariants on the card."""
    from paddle_tpu_torch.fluid import layers as L
    from paddle_tpu_torch.nn import functional as F

    gen = torch.Generator().manual_seed(SEED + 24)
    out = {"crf": {
        "SQ2": _sq_crf_checks(torch, F, gen, SQ2_B, SQ2_T, SQ2_TAGS, "SQ2"),
        "SQ3": _sq_crf_checks(torch, F, gen, SQ3_B, SQ3_S, SQ3_TAGS,
                              "SQ3")}}
    for group, cases in (("sequence", _sq_sequence_cases(torch, gen)),
                         ("small", _sq_small_cases(torch, gen))):
        out[group] = {label: _b_pair(torch, label, fn, arrays, grad=grad,
                                     phase="SQ1", tol=SQ_TOL)
                      for label, fn, arrays, grad in cases}
    # filter_by_instag: eager, a data-dependent row count
    ins = torch.randn(50, 8, generator=gen)
    tags = torch.randint(0, 6, (50, 3), generator=gen)
    for want in ([2, 5], [9]):
        c = L.filter_by_instag(ins, tags, torch.tensor(want))
        d = L.filter_by_instag(ins.to(DEVICE), tags.to(DEVICE),
                               torch.tensor(want).to(DEVICE))
        assert all(torch.equal(a.cpu(), b) for a, b in zip(d, c)), want
    # the random ops on the card: shapes, ranges, one seed repeats
    dev = torch.device(DEVICE)
    p = torch.full((4096, 8), 0.125, device=dev)
    ids = F.sampling_id(p, seed=3)
    assert torch.equal(ids, F.sampling_id(p, seed=3))
    assert int(ids.min()) >= 0 and int(ids.max()) <= 7
    u = F.uniform_random_batch_size_like(p, [1, 64], min=-2.0, max=0.5)
    assert tuple(u.shape) == (4096, 64) and u.device == p.device
    assert float(u.min()) >= -2.0 and float(u.max()) < 0.5
    g = F.gaussian_random_batch_size_like(p, [1, 64], mean=1.0, std=0.5)
    assert abs(float(g.mean()) - 1.0) < 0.01
    img = torch.arange(4 * 3 * 9 * 9, dtype=torch.float32,
                       device=dev).reshape(4, 3, 9, 9)
    crop = L.random_crop(img, [5, 6], seed=5)
    assert tuple(crop.shape) == (4, 3, 5, 6)
    assert torch.equal(crop, L.random_crop(img, [5, 6], seed=5))
    logits = torch.randn(512, 1000, device=dev)
    label = torch.randint(0, 1000, (512, 1), device=dev)
    ss = L.sampled_softmax_with_cross_entropy(logits, label, 64)
    assert tuple(ss.shape) == (512, 1) and bool((ss > 0).all())
    n_checks = sum(len(v) for k, v in out.items() if k != "crf") + 6
    worst = max(max(r["max_err"], r["grad_err"]) for k, v in out.items()
                if k != "crf" for r in v.values())
    worst = max([worst] + [max(c["nll"]["max_err"], c["nll"]["grad_err"],
                               c["score_err"]) for c in out["crf"].values()])
    log(f"SQ1: {n_checks} checks card vs CPU, largest error {worst:.2e} x "
        f"rms (tol {SQ_TOL:.0e}); filter_by_instag equal; the random ops' "
        f"invariants on the card hold")
    out["worst"] = worst
    return out


def _sq_profile_launches(torch, run):
    """Kernels the card ran during ``run()`` by ``torch.profiler`` (None
    when the profiler saw no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if "CUDA" in str(e.device_type)
            and not e.name.startswith(("Memcpy", "Memset")))
    return n or None


def _sq_event_ms(torch, fn, reps=10):
    """Median CUDA-event ms of ``fn()`` over ``reps`` calls (after one)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def _sq_crf_times(torch, F, em, tr, y, ln):
    """The CRF loss's forward, its forward + backward and the Viterbi
    decode on the path's tensors: CUDA-event ms of the eager calls, and
    the device ms of a CUDA graph of each (what they cost inside a
    replayed step)."""
    em = em.detach().float()
    tr = tr.detach().float()
    emg = em.clone().requires_grad_(True)

    def fwd():
        with torch.no_grad():
            return F.linear_chain_crf(em, tr, y, ln)

    def fwd_bwd():
        return torch.autograd.grad(
            F.linear_chain_crf(emg, tr, y, ln).mean(), [emg])

    def decode():
        return F.crf_decoding(em, tr, length=ln)

    out = {"forward_ms": _sq_event_ms(torch, fwd),
           "forward_backward_ms": _sq_event_ms(torch, fwd_bwd),
           "decode_ms": _sq_event_ms(torch, decode)}
    out["forward_graph_ms"] = graph_ms(torch, lambda: fwd(), [()], 5)
    out["forward_backward_graph_ms"] = graph_ms(torch, lambda: fwd_bwd(),
                                                [()], 5)
    out["decode_graph_ms"] = graph_ms(torch, lambda: decode(), [()], 5)
    return out


def _sq_markov(np, rng, B, T, n_tags, trans):
    """``[B, T]`` tags from a Markov chain (first tag uniform)."""
    cum = np.cumsum(trans, 1)
    tags = np.zeros((B, T), np.int64)
    cur = rng.randint(0, n_tags, B)
    for t in range(T):
        tags[:, t] = cur
        u = rng.rand(B)
        cur = np.minimum((cum[cur] < u[:, None]).sum(1), n_tags - 1)
    return tags


def lac_batches(np, n, seed):
    """``n`` seeded LAC batches: tags from a Markov chain over the 57 tags
    (B- / I- of 28 chunk types, then O); each word names its tag's chunk
    type (B- and I- of a type aliased, so the transitions carry
    information); lengths 8-64, word 0 and tag 0 past them."""
    rng = np.random.RandomState(seed)
    trans = rng.dirichlet(np.full(SQ2_TAGS, 0.3), SQ2_TAGS)
    per_type = (SQ2_VOCAB - 1) // 29
    out = []
    for _ in range(n):
        tags = _sq_markov(np, rng, SQ2_B, SQ2_T, SQ2_TAGS, trans)
        words = 1 + (tags // 2) * per_type + rng.randint(0, per_type,
                                                         tags.shape)
        ln = rng.randint(8, SQ2_T + 1, SQ2_B).astype(np.int64)
        pad = np.arange(SQ2_T)[None] >= ln[:, None]
        out.append({"word": np.where(pad, 0, words).astype(np.int64),
                    "target": np.where(pad, 0, tags).astype(np.int64),
                    "length": ln})
    return out


def lac_program(fluid):
    """LAC's network (lexical_analysis nets.py) in a Program: embedding, 2
    x BiGRU (fc(3H) → dynamic_gru each way, concatenated), fc(57)
    emissions, linear_chain_crf on a create_parameter transition, Viterbi
    decoding, Adam(1e-3)."""
    main, start = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.program_guard(main, start):
        word = fluid.data("word", [-1, SQ2_T], dtype="int64")
        target = fluid.data("target", [-1, SQ2_T], dtype="int64")
        length = fluid.data("length", [-1], dtype="int64")
        h = L.embedding(word, size=[SQ2_VOCAB, SQ2_EMB])
        for _ in range(2):
            fw = L.dynamic_gru(L.fc(h, 3 * SQ2_HID, num_flatten_dims=2),
                               SQ2_HID)
            bw = L.dynamic_gru(L.fc(h, 3 * SQ2_HID, num_flatten_dims=2),
                               SQ2_HID, is_reverse=True)
            h = L.concat([fw, bw], axis=2)
        emission = L.fc(h, SQ2_TAGS, num_flatten_dims=2)
        transition = L.create_parameter([SQ2_TAGS + 2, SQ2_TAGS], "float32",
                                        name="crfw")
        loss = L.mean(L.linear_chain_crf(emission, transition, target,
                                         length))
        decode = L.crf_decoding(emission, transition, length=length)
        fluid.optimizer.Adam(1e-3).minimize(loss)
    return main, start, {"loss": loss, "decode": decode,
                         "emission": emission, "transition": transition}


def _sq_chunks(torch, decode, feed):
    """chunk_eval's counts (IOB, 28 chunk types) of a decoded batch."""
    from paddle_tpu_torch.metric import chunk_eval

    got = chunk_eval(decode.cpu(), torch.from_numpy(feed["target"]), "IOB",
                     28, seq_length=torch.from_numpy(feed["length"]))
    return [int(v) for v in got[3:]]


def lac_static(torch, gpu):
    """Phase SQ2: LAC's BiGRU-CRF through the 1.x static graph on the
    card, at batch 300 x 64: eager ``exe.run`` steps, then
    ``run_steps`` windows (eager, capture, replay); a deterministic window
    against ``exe.run`` steps; the decoded paths against the CPU route;
    ``fluid.io`` persistables reloaded into a fresh scope."""
    import shutil
    import tempfile

    import numpy as np

    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.static.graph import _copy_into

    paddle.seed(SEED)
    t0 = time.perf_counter()
    main, start, v = lac_program(fluid)
    build_s = time.perf_counter() - t0
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(start)
    feeds = lac_batches(np, SQ2_BATCHES, SEED + 25)
    fetch = [v["loss"]]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(SQ2_WARMUP):
        losses.append(float(exe.run(main, feed=feeds[i % SQ2_BATCHES],
                                    fetch_list=fetch)[0]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(SQ2_STEPS):
        losses.append(float(exe.run(main, feed=feeds[i % SQ2_BATCHES],
                                    fetch_list=fetch)[0]))
    eager_s = (time.perf_counter() - t0) / SQ2_STEPS
    tokens = float(np.mean([f["length"].sum() for f in feeds]))
    launches = _sq_profile_launches(torch, lambda: exe.run(
        main, feed=feeds[0], fetch_list=fetch))
    stacked = {k: np.stack([feeds[i % SQ2_BATCHES][k]
                            for i in range(SQ2_WINDOW)]) for k in feeds[0]}

    def window(ex):
        out, = ex.run_steps(main, feed=stacked, fetch_list=fetch,
                            iterations=SQ2_WINDOW)
        return [float(x) for x in np.asarray(out).reshape(-1)]

    windows, seconds = [], []
    for _ in range(3):  # eager, capture, replay
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        windows.append(window(exe))
        seconds.append(time.perf_counter() - t0)
    replay_s = seconds[-1] / SQ2_WINDOW
    peak = torch.cuda.max_memory_allocated()
    finite = all(math.isfinite(x) for x in losses + sum(windows, []))
    assert finite, (losses, windows)
    assert np.mean(windows[-1]) < losses[SQ2_WARMUP], (losses, windows)
    log(f"SQ2 LAC BiGRU-CRF [{gpu}] ({SQ2_CONFIG}): program built in "
        f"{build_s:.1f} s; losses eager {[round(x, 3) for x in losses]}, "
        f"windows' last {[round(w[-1], 3) for w in windows]}; eager "
        f"{eager_s * 1e3:.2f} ms a step ({SQ2_B / eager_s:.1f} sentences/s, "
        f"{tokens / eager_s:.0f} tokens/s), replayed {replay_s * 1e3:.2f} "
        f"ms a step ({SQ2_B / replay_s:.1f} sentences/s, "
        f"{tokens / replay_s:.0f} tokens/s; windows {[round(s, 3) for s in seconds]} "
        f"s: eager, capture, replay); kernels a step "
        f"{launches if launches is not None else 'not measured'} "
        f"(torch.profiler, one eager step); peak {peak / 2**20:.0f} MiB")

    # the CRF on the step's own tensors, by CUDA events
    check = feeds[0]
    test = main.clone(for_test=True)
    em, dec = exe.run(test, feed=check,
                      fetch_list=[v["emission"], v["decode"]],
                      return_numpy=False)
    tr = main.scope[v["transition"].name]
    y = torch.from_numpy(check["target"]).to(DEVICE)
    ln = torch.from_numpy(check["length"]).to(DEVICE)
    crf = _sq_crf_times(torch, F, em, tr, y, ln)
    crf["share_of_eager_step"] = (crf["forward_backward_ms"]
                                  + crf["decode_ms"]) / (eager_s * 1e3)
    crf["share_of_replayed_step"] = (crf["forward_backward_graph_ms"]
                                     + crf["decode_graph_ms"]) / (
                                         replay_s * 1e3)
    log(f"SQ2 CRF [{gpu}] at [{SQ2_B}, {SQ2_T}, {SQ2_TAGS}], eager (CUDA "
        f"graph): loss forward {crf['forward_ms']:.3f} "
        f"({crf['forward_graph_ms']:.3f}) ms, forward + backward "
        f"{crf['forward_backward_ms']:.3f} "
        f"({crf['forward_backward_graph_ms']:.3f}) ms, decode "
        f"{crf['decode_ms']:.3f} ({crf['decode_graph_ms']:.3f}) ms; loss "
        f"and decode {crf['share_of_eager_step']:.1%} of an eager step, "
        f"their graphs {crf['share_of_replayed_step']:.1%} of a replayed "
        f"one")
    counts = [_sq_chunks(torch, dec, check)]
    metric = fluid.metrics.ChunkEvaluator()
    metric.update(*counts[0])
    p, r, f1 = metric.eval()
    log(f"SQ2 ChunkEvaluator on a training batch after "
        f"{SQ2_WARMUP + SQ2_STEPS + 3 * SQ2_WINDOW} steps: precision "
        f"{p:.4f}, recall {r:.4f}, F1 {f1:.4f} (counts {counts[0]})")

    # fluid.io: the persistables into a fresh, identically built program
    tmp = tempfile.mkdtemp(prefix="sq2_")
    try:
        fluid.io.save_persistables(exe, tmp, main)
        paddle.seed(SEED + 1)
        main2, start2, v2 = lac_program(fluid)
        exe2 = fluid.Executor(fluid.CUDAPlace(0))
        exe2.run(start2)
        fluid.io.load_persistables(exe2, tmp, main2)
        dec2, = exe2.run(main2.clone(for_test=True), feed=check,
                         fetch_list=[v2["decode"]], return_numpy=False)
        assert torch.equal(dec2, dec), "SQ2: reloaded persistables decode"
        saved = sum(os.path.getsize(os.path.join(tmp, f))
                    for f in os.listdir(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del exe2, main2, start2
    log(f"SQ2 fluid.io: save_persistables ({saved / 2**20:.1f} MiB, "
        f"{len(main.scope) + len(main.buffers)} variables) then "
        f"load_persistables into a fresh scope decodes bit-equal")

    # one window under deterministic algorithms against 10 exe.run steps
    exe.close()
    gc.collect()
    with _deterministic_algorithms(torch):
        exe3 = fluid.Executor(fluid.CUDAPlace(0))
        window(exe3)
        window(exe3)  # eager, then the capture: the next is a replay

        def snapshot():
            return ({n: t.detach().clone() for n, t in main.scope.items()},
                    _clone_state(main._opt_state))

        scope0, state0 = snapshot()
        replayed = window(exe3)
        scope1, state1 = snapshot()
        with torch.no_grad():
            for n, t in main.scope.items():
                t.copy_(scope0[n])
        _copy_into(main._opt_state, _clone_state(state0))
        eager = [float(exe3.run(main, feed={k: a[i] for k, a in
                                            stacked.items()},
                                fetch_list=fetch)[0])
                 for i in range(SQ2_WINDOW)]
        scope2, state2 = snapshot()
    diff = _tree_diff(scope1, scope2)
    diff.update(_tree_diff(state1, state2))
    log(f"SQ2 deterministic algorithms: a replayed window against "
        f"{SQ2_WINDOW} exe.run steps from the same state: losses "
        f"{replayed[-1]!r} / {eager[-1]!r}; tensors differing "
        f"{len(diff)}: {sorted(diff)[:6]}")
    assert replayed == eager and not diff, (replayed, eager,
                                            sorted(diff.items())[:6])
    exe3.close()
    del scope0, scope1, scope2, state0, state1, state2
    gc.collect()

    # the decoded paths against the CPU route on the same scope (moved)
    em, dec = exe3.run(test, feed=check,
                       fetch_list=[v["emission"], v["decode"]],
                       return_numpy=False)
    emc, decc = fluid.Executor(fluid.CPUPlace()).run(
        test, feed=check, fetch_list=[v["emission"], v["decode"]],
        return_numpy=False)
    e_err = _b_err(torch, em, emc)
    assert e_err <= SQ_TOL, e_err
    ties = _sq_paths(torch, "SQ2 decode", dec, decc, emc,
                     test.scope[v["transition"].name],
                     torch.from_numpy(check["length"]))
    log(f"SQ2 card vs CPU route (scope copied to the CPU): emissions "
        f"{e_err:.2e} x rms, decoded paths equal but {ties} tied rows")
    out = {"config": SQ2_CONFIG, "build_s": build_s,
           "eager_step_ms": eager_s * 1e3,
           "replayed_step_ms": replay_s * 1e3,
           "window_s": seconds, "sentences_per_s": {
               "eager": SQ2_B / eager_s, "replayed": SQ2_B / replay_s},
           "tokens_per_s": {"eager": tokens / eager_s,
                            "replayed": tokens / replay_s},
           "launches_per_step": launches, "crf": crf,
           "chunk": {"precision": p, "recall": r, "f1": f1,
                     "counts": counts[0]},
           "losses": losses, "window_losses": windows,
           "peak_bytes": peak, "emission_err": e_err, "tied_rows": ties,
           "bit_equal_window": True, "persistables_bit_equal": True}
    del exe, main, start, test
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def recording_ln_kernels(calls):
    """While open, every launch of kernel 2 (forward and backward) appends
    ``(kind, inputs, outputs)`` to ``calls``, copied at the launch (the
    launchers are wrapped; the wrapper and its counters stay)."""
    from paddle_tpu_torch.ops import fused_layernorm as fl

    fwd, bwd = fl._forward_kernel, fl._backward_kernel

    def copy(ts):
        return tuple(None if t is None else t.detach().clone() for t in ts)

    def rec_fwd(x2, r2, weight, bias, epsilon, design=None):
        out = fwd(x2, r2, weight, bias, epsilon, design=design)
        calls.append(("forward", copy((x2, r2, weight, bias)) + (epsilon,),
                      copy(out)))
        return out

    def rec_bwd(s, mean, rstd, weight, ds_out, dy, design=None):
        out = bwd(s, mean, rstd, weight, ds_out, dy, design=design)
        calls.append(("backward", copy((s, mean, rstd, weight, ds_out, dy)),
                      copy(out)))
        return out

    fl._forward_kernel, fl._backward_kernel = rec_fwd, rec_bwd
    try:
        yield calls
    finally:
        fl._forward_kernel, fl._backward_kernel = fwd, bwd


def check_path_ln_kernels(torch, calls, label):
    """Kernel 2 at every launch a path made (``calls`` from
    :func:`recording_ln_kernels`) against its plain versions on the same
    inputs at phase 6's tolerances: the forward's s exact, y within
    ``ln_tol``, mean and rstd 1e-5; the backward's ds within ``ln_tol``,
    dg and db within it after scaling by their largest magnitude.  Returns
    a row per (direction, shape): calls and largest errors."""
    from paddle_tpu_torch.ops import fused_layernorm as fl

    rows = {}
    for kind, args, out in calls:
        if kind == "forward":
            x2, r2, g, b, eps = args
            dtype = str(x2.dtype).replace("torch.", "")
            tol = ln_tol(dtype)
            s0, y0, m0, rs0 = fl._forward_ref(x2, r2, g, b, eps)
            s, y, m, rs = out
            assert torch.equal(s, s0), (label, "s differs")
            torch.testing.assert_close(y, y0, **tol)
            torch.testing.assert_close(m, m0, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(rs, rs0, rtol=1e-5, atol=1e-5)
            err = float((y.float() - y0.float()).abs().max())
            shape = f"forward {dtype} {list(x2.shape)}"
        else:
            s, mean, rstd, g, ds_out, dy = args
            dtype = str(s.dtype).replace("torch.", "")
            tol = ln_tol(dtype)
            want = fl._backward_ref(s, mean, rstd, g, ds_out, dy)
            torch.testing.assert_close(out[0], want[0], **tol)
            for a, w in zip(out[1:], want[1:]):
                scale = max(1.0, float(w.float().abs().max()))
                torch.testing.assert_close(a.float() / scale,
                                           w.float() / scale, **tol)
            err = float((out[0].float() - want[0].float()).abs().max())
            shape = (f"backward {dtype} {list(s.shape)}"
                     f"{' + s cotangent' if ds_out is not None else ''}")
        row = rows.setdefault(shape, {"shape": shape, "calls": 0,
                                      "max_abs_err": 0.0})
        row["calls"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], err)
    log(f"{label}: kernel 2 at the {len(rows)} shapes the path gave it, on "
        f"its inputs: " + "; ".join(
            f"{r['shape']} x {r['calls']}: max_abs_err {r['max_abs_err']:.3e}"
            for r in rows.values()) + " (phase 6's tolerances); ok")
    return list(rows.values())


def sq3_batch(np, vocab, seed):
    """msra_ner-shaped seeded batch: BIO tags from a Markov chain over the
    7 tags (B- / I- of 3 entity types, then O), token ids that name their
    tag's entity type (B- and I- aliased, as SQ2's words), attention mask,
    lengths 16-128 (one 1, one 128)."""
    rng = np.random.RandomState(seed)
    trans = rng.dirichlet(np.full(SQ3_TAGS, 0.5), SQ3_TAGS)
    tags = _sq_markov(np, rng, SQ3_B, SQ3_S, SQ3_TAGS, trans)
    ln = rng.randint(16, SQ3_S + 1, SQ3_B).astype(np.int64)
    ln[0], ln[1] = 1, SQ3_S
    pad = np.arange(SQ3_S)[None] >= ln[:, None]
    per_type = (vocab - 1) // 4
    ids = (1 + (tags // 2) * per_type
           + rng.randint(0, per_type, tags.shape)).astype(np.int64)
    return ([np.where(pad, 0, ids), (~pad).astype(np.int64)],
            [np.where(pad, 0, tags).astype(np.int64), ln])


def bert_crf_tagger(torch, cfg, device):
    """``BertModel(cfg)`` (bf16) → ``Linear(768, tags)`` (bf16) emissions,
    and a float32 ``[tags + 2, tags]`` CRF transition; the loss is
    ``linear_chain_crf(...).mean()``."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models import BertModel
    from paddle_tpu_torch.nn import functional as F

    class BertCrfTagger(nn.Layer):
        def __init__(self):
            super().__init__()
            self.bert = BertModel(cfg, device=device).astype("bfloat16")
            self.head = nn.Linear(cfg.hidden_size, SQ3_TAGS).astype(
                "bfloat16")
            self.transition = self.create_parameter(
                [SQ3_TAGS + 2, SQ3_TAGS])
            self.to(device)

        def forward(self, ids, mask):
            x, _ = self.bert(ids, attention_mask=mask)
            return self.head(x), self.transition

        @staticmethod
        def loss(emissions, transition, labels, lengths):
            return F.linear_chain_crf(emissions, transition, labels,
                                      lengths).mean()

    return BertCrfTagger()


def bert_crf_train(torch, gpu):
    """Phase SQ3: the BERT-base CRF tagger through ``Model.train_batch``
    at msra_ner's 32 x 128: 2 warm-up and 10 timed steps, kernel 2 24 + 24
    launches a step; a check step whose kernel-2 calls are held to plain;
    ``crf_decoding`` on the card against the CPU route."""
    import numpy as np

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import bert_base
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import layernorm_residual

    cfg = bert_base()
    ptt.seed(SEED)
    net = bert_crf_tagger(torch, cfg, DEVICE)
    assert type(net.transition).__name__ == "Parameter"
    opt = ptt.optimizer.AdamW(learning_rate=SQ3_LR, weight_decay=0.01,
                              multi_precision=True)
    model = ptt.Model(net, ["input_ids", "attention_mask"],
                      ["labels", "lengths"]).prepare(optimizer=opt,
                                                     loss=net.loss)
    inputs, labels = sq3_batch(np, cfg.vocab_size, SEED + 26)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, wall, (ln,) = train_steps(torch, model, inputs, labels,
                                      SQ3_WARMUP, SQ3_STEPS,
                                      (layernorm_residual,))
    peak = torch.cuda.max_memory_allocated()
    want = 2 * cfg.num_layers * SQ3_STEPS
    log(f"SQ3 BERT-base CRF tagger [{gpu}] ({SQ3_CONFIG}): losses "
        f"{[round(x, 4) for x in losses]}; kernel 2 launches over "
        f"{SQ3_STEPS} steps: forward {ln} (= {want}: {ln == want})")
    assert ln == want, ln
    lnb = ln_backward_gate(layernorm_residual, ln, "SQ3")
    assert all(math.isfinite(x) for x in losses), losses
    assert max(losses[SQ3_WARMUP:]) <= SQ3_RISE * losses[0], losses
    step_ms = wall / SQ3_STEPS * 1e3
    tokens = float(labels[1].sum())
    # the check step: every kernel-2 call held to plain on its inputs
    calls = []
    with recording_ln_kernels(calls):
        model.train_batch(inputs, labels)
        torch.cuda.synchronize()
    n_fwd = sum(1 for c in calls if c[0] == "forward")
    assert n_fwd == 2 * cfg.num_layers and len(calls) == 2 * n_fwd, (
        n_fwd, len(calls))
    path = check_path_ln_kernels(torch, calls, "SQ3 check step")
    del calls
    # the CRF on the step's emissions, and the decode against the CPU's
    net.eval()
    with torch.no_grad():
        em, tr = net(*[torch.from_numpy(a).to(DEVICE) for a in inputs])
    net.train()
    em = em.float()
    y = torch.from_numpy(labels[0]).to(DEVICE)
    lens = torch.from_numpy(labels[1]).to(DEVICE)
    crf = _sq_crf_times(torch, F, em, tr, y, lens)
    crf["share_of_step"] = crf["forward_backward_ms"] / step_ms
    dc = F.crf_decoding(em, tr.detach(), length=lens)
    cc = F.crf_decoding(em.cpu(), tr.detach().cpu(), length=lens.cpu())
    ties = _sq_paths(torch, "SQ3 decode", dc, cc, em.cpu(), tr.cpu(),
                     lens.cpu())
    log(f"SQ3 [{gpu}]: {step_ms:.2f} ms a step, "
        f"{SQ3_B / (step_ms / 1e3):.1f} seq/s, "
        f"{tokens / (step_ms / 1e3):.0f} tokens/s (the lengths' sum), peak "
        f"{peak / 2**20:.0f} MiB; the CRF at [{SQ3_B}, {SQ3_S}, {SQ3_TAGS}], "
        f"eager (CUDA graph): loss forward {crf['forward_ms']:.3f} "
        f"({crf['forward_graph_ms']:.3f}) ms, forward + backward "
        f"{crf['forward_backward_ms']:.3f} "
        f"({crf['forward_backward_graph_ms']:.3f}) ms = "
        f"{crf['share_of_step']:.1%} of a step, decode "
        f"{crf['decode_ms']:.3f} ({crf['decode_graph_ms']:.3f}) ms; decode "
        f"card vs CPU equal but {ties} tied rows")
    out = {"config": SQ3_CONFIG, "step_ms": step_ms,
           "seq_per_s": SQ3_B / (step_ms / 1e3),
           "tokens_per_s": tokens / (step_ms / 1e3), "losses": losses,
           "launches": {"layernorm_residual": ln,
                        "layernorm_residual_backward": lnb},
           "launches_per_step": {"forward": ln / SQ3_STEPS,
                                 "backward": lnb / SQ3_STEPS},
           "kernel_path_checks": path, "crf": crf, "tied_rows": ties,
           "peak_bytes": peak}
    del model, opt, net, em
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sq4_program(fluid):
    """The 1.x builders in one Program: nce (seeded negatives),
    center_loss, sequence_conv, data_norm, inplace_abn, lstm, lstm_unit,
    gru_unit, dynamic_lstm (peepholes), dynamic_lstmp, dynamic_gru both
    origin modes; Adam(1e-2) on the sum of their means."""
    main, start = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.program_guard(main, start):
        x = fluid.data("x", [-1, 16])
        lbl = fluid.data("lbl", [-1, 1], dtype="int64")
        seq = fluid.data("seq", [-1, 12, 16])
        img = fluid.data("img", [-1, 8, 6, 6])
        x3 = fluid.data("x3", [-1, 12, 24])
        x4 = fluid.data("x4", [-1, 12, 32])
        h = fluid.data("h", [-1, 8])
        c = fluid.data("c", [-1, 8])
        h0 = fluid.data("h0", [2, -1, 8])
        c0 = fluid.data("c0", [2, -1, 8])
        outs = [L.nce(x, lbl, num_total_classes=1000, num_neg_samples=16,
                      seed=7),
                L.center_loss(x, lbl, num_classes=1000, alpha=0.1),
                L.sequence_conv(seq, num_filters=32, filter_size=3,
                                act="relu"),
                L.data_norm(x, enable_scale_and_shift=True),
                L.inplace_abn(img, act="relu")]
        outs += list(L.lstm(seq, h0, c0, 12, 8, 1, is_bidirec=True))
        outs += list(L.lstm_unit(x, h, c, forget_bias=1.0))
        outs += list(L.gru_unit(x3[:, 0], h, 24))
        outs += list(L.dynamic_lstm(x4, 32, use_peepholes=True))
        outs += list(L.dynamic_lstmp(x4, 32, proj_size=6))
        outs += [L.dynamic_gru(x3, 8),
                 L.dynamic_gru(x3, 8, origin_mode=True, is_reverse=True)]
        loss = L.sums([L.mean(o) for o in outs])
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return main, start, outs, loss


def sq4_builders(torch, gpu):
    """Phase SQ4: :func:`sq4_program` on the card and on the CPU from one
    scope state, two ``exe.run`` Adam steps each: every output, the losses
    and the updated parameters and buffers within 1e-4 of the CPU rms."""
    import numpy as np

    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.bridge import load_jax_program

    rng = np.random.RandomState(SEED + 27)
    B = 64
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    feed = {"x": f32(B, 16), "seq": f32(B, 12, 16), "img": f32(B, 8, 6, 6),
            "x3": f32(B, 12, 24), "x4": f32(B, 12, 32), "h": f32(B, 8),
            "c": f32(B, 8), "h0": f32(2, B, 8) * 0.1,
            "c0": f32(2, B, 8) * 0.1,
            "lbl": rng.randint(0, 1000, (B, 1)).astype(np.int64)}
    runs = []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        paddle.seed(SEED)
        main, start, outs, loss = sq4_program(fluid)
        exe = fluid.Executor(place)
        exe.run(start)
        runs.append((main, exe, list(outs) + [loss]))
    # one scope state: the card program's initial values into the CPU's
    dm0 = runs[0][0]
    load_jax_program(runs[1][0], dm0.parameters_numpy(),
                     {n: b.detach().cpu().numpy()
                      for n, b in dm0.buffers.items()})
    for i, (main, exe, fetch) in enumerate(runs):
        runs[i] = (main, [exe.run(main, feed=feed, fetch_list=fetch)
                          for _ in range(2)])
    (dm, dsteps), (cm, csteps) = runs
    worst = 0.0
    for ds, cs in zip(dsteps, csteps):
        for a, b in zip(ds, cs):
            worst = max(worst, _b_err(torch, torch.from_numpy(np.asarray(a)),
                                      torch.from_numpy(np.asarray(b))))
    state_worst = 0.0
    for mine, theirs in ((dm.scope, cm.scope), (dm.buffers, cm.buffers)):
        key = lambda n: n.split("_", 2)[2]  # noqa: E731
        theirs = {key(n): t for n, t in theirs.items()}
        for n, t in mine.items():
            state_worst = max(state_worst, _b_err(
                torch, t.detach().float(), theirs[key(n)].detach().float()))
    log(f"SQ4 builders [{gpu}]: nce (seeded negatives), center_loss, "
        f"sequence_conv, data_norm, inplace_abn, lstm, lstm_unit, gru_unit, "
        f"dynamic_lstm (peepholes), dynamic_lstmp, dynamic_gru (both origin "
        f"modes) in one Program, 2 Adam steps card vs CPU: {len(dsteps[0])} "
        f"fetches a step within {worst:.2e} x rms, {len(dm.scope)} "
        f"parameters and {len(dm.buffers)} buffers within "
        f"{state_worst:.2e} (tol {SQ_TOL:.0e})")
    assert worst <= SQ_TOL and state_worst <= SQ_TOL, (worst, state_worst)
    return {"fetch_err": worst, "state_err": state_worst,
            "parameters": len(dm.scope), "buffers": len(dm.buffers)}


def tagging_phases(torch, gpu):
    """SQ1-SQ4, then the ``{"tagging": ...}`` line; returns what the
    kernels line needs."""
    sq = {}
    t0 = time.monotonic()
    sq["SQ1"] = tagging_ops_card_vs_cpu(torch)
    gc.collect()
    torch.cuda.empty_cache()
    sq["SQ2"] = lac_static(torch, gpu)
    sq["SQ3"] = bert_crf_train(torch, gpu)
    sq["SQ4"] = sq4_builders(torch, gpu)
    sq["seconds"] = time.monotonic() - t0
    log(json.dumps({"tagging": {"device": gpu, **{
        k: v for k, v in sq.items() if k != "SQ1"},
        "SQ1": {"worst": sq["SQ1"]["worst"], "crf": sq["SQ1"]["crf"]}}},
        default=str))
    return sq


# -- distributed execution (DX0-DX4) ----------------------------------------
# One card: the multi-rank legs run as ranks that share cuda:0 over a gloo
# group (NCCL refuses two ranks on one card), their collectives staged
# through pinned host buffers; the NCCL route runs at world size 1 (DX0).
# Their times measure the kernels and the host, never an interconnect.
DX_LR = 1e-4                   # AdamW's rate in DX2 / DX3
# DX3's ring chunks against the plain backward on their own inputs: each
# of dq, dk, dv within 2e-2 of the plain one's L2 norm (the port's bf16
# tolerance).  LT1's per-element FLASH_BWD_TOL holds on random inputs; on
# the model's chunks it did not (1.8x its 1e-3 tensor floor, then 1.18x a
# 1e-2 floor, first card runs): at init attention is near uniform and a
# chunk's partial dk sums p (dp - delta) q over rows whose ds cancel (a
# softmax row's ds sum to 0), so the result is far smaller than its terms
# and the kernels' bf16 rounding of p and ds is large beside it
RING_CHUNK_REL_L2 = 2e-2
DX_TIMEOUT = 900               # spawn's join deadline, seconds
DX_RANKS = 4


def dx_conf():
    """What the ranks run (passed to them: a spawned rank imports this
    module afresh, so module globals changed by a caller do not reach
    it).  DX2: gpt_small f32 (dropout 0: a mask is drawn per rank, so
    with dropout the ranks cannot equal one device), sharding 2 x model 2,
    global batch 8 x 1024, 3 steps; DX3: the long-context slice's model in
    bf16, sep 2 x model 2, ring attention, 2 x 8192, 3 steps; DX4: a conv
    net with SyncBatchNorm under DataParallel at 2 ranks."""
    return {
        "device": DEVICE,
        "dx1": dict(rows=1000, cols=257),
        "dx2": dict(cfg=dict(dropout=0.0), B=GPT_B, S=GPT_S, steps=3,
                    lr=DX_LR),
        "dx3": dict(cfg=dict(max_position=LC_S, dropout=0.0), B=LC_B,
                    S=LC_S, steps=3, lr=DX_LR),
        "dx4": dict(B=16, C=3, HW=32, F=16, steps=3),
    }


def _dx_gpt(torch, cfg, dtype, device, **kw):
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_small

    net = GPTForCausalLM(gpt_small(**cfg, **kw), device=device,
                         generator=torch.Generator().manual_seed(SEED))
    return net.astype(dtype) if dtype != "float32" else net


def _dx_ids(np, cfg, B, S, seed):
    vocab = cfg.get("vocab_size", 50304)
    return np.random.RandomState(seed).randint(
        0, vocab, size=(B, S)).astype(np.int32)


def dx_references(torch, gpu, conf, workdir):
    """The single-rank runs the ranks are held to, on this process's card:
    DX2's model through the plain ``train_batch`` (losses; final
    parameters saved to ``workdir`` for the ranks to compare), DX3's
    through the LT2 path (kernels 4-6 over the whole sequence)."""
    import numpy as np

    import paddle_tpu_torch as ptt

    out = {}
    for leg, dtype in (("dx2", "float32"), ("dx3", "bfloat16")):
        c = conf[leg]
        net = _dx_gpt(torch, c["cfg"], dtype, conf["device"])
        opt = ptt.optimizer.AdamW(learning_rate=c["lr"], weight_decay=0.01,
                                  multi_precision=True)
        model = ptt.Model(net).prepare(optimizer=opt, loss=net.loss)
        ids = _dx_ids(np, c["cfg"], c["B"], c["S"], SEED + 91)
        t0 = time.monotonic()
        losses = [model.train_batch([ids], [ids])[0]
                  for _ in range(c["steps"])]
        if conf["device"].startswith("cuda"):
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        out[leg] = dict(losses=losses, seconds=wall)
        if leg == "dx2":
            path = os.path.join(workdir, "dx2_reference.pt")
            torch.save({k: p.detach().cpu() for k, p in
                        net.named_parameters()}, path)
            out[leg]["path"] = path
        log(f"DX ref[{leg}][{gpu}]: one rank, plain train_batch, "
            f"{c['steps']} steps in {wall:.3f}s, losses {losses}")
        del model, opt, net
        gc.collect()
        if conf["device"].startswith("cuda"):
            torch.cuda.empty_cache()
    return out


def dx_collectives(torch, conf):
    """DX1 (and DX0 at world size 1): every collective of
    ``distributed.collective`` on this rank's slot of seeded stacked
    inputs, held to the stacked result JAX's semantics give, computed
    here from the whole stacked input on the CPU."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.mesh import build_mesh, set_mesh

    dev = conf["device"]
    n, r = dist.get_world_size(), dist.get_rank()
    set_mesh(build_mesh())
    gen = torch.Generator().manual_seed(SEED + 90)
    rows, cols = conf["dx1"]["rows"], conf["dx1"]["cols"]
    a = torch.randn(n, rows, cols, generator=gen)
    m = torch.randn(n, n, 64, 33, generator=gen)
    c = torch.randn(n, n * 8, 129, generator=gen)
    errs = {}

    def check(name, got, want, rtol=0.0):
        got = got.float().cpu() if isinstance(got, torch.Tensor) \
            else torch.stack([g.float().cpu() for g in got])
        assert got.device.type == "cpu" and got.shape == want.shape, name
        err = float((got - want).abs().max()) if want.numel() else 0.0
        allow = rtol * float(want.abs().max()) if rtol else 0.0
        assert err <= allow, f"DX collective {name}: error {err} > {allow}"
        errs[name] = err

    # a copy: the in-place collectives must not write the stacked input
    mine = lambda t: t[r].to(dev, copy=True)  # noqa: E731
    sum_tol = 1e-6 * n
    check("all_reduce_sum", dist.all_reduce(mine(a)), a.sum(0), sum_tol)
    check("all_reduce_max", dist.all_reduce(mine(a), op="max"), a.amax(0))
    check("all_reduce_min", dist.all_reduce(mine(a), op="min"), a.amin(0))
    check("all_reduce_prod", dist.all_reduce(mine(a), op="prod"),
          a.prod(0), sum_tol)
    check("bf16_all_reduce", dist.all_reduce(mine(a).bfloat16()),
          a.sum(0).bfloat16().float(), 2 ** -7)
    check("all_gather", dist.all_gather(mine(a)), a)
    dst = min(1, n - 1)
    check("reduce", dist.reduce(mine(a), dst=dst),
          a.sum(0) if r == dst else a[r], sum_tol)
    src = min(2, n - 1)
    check("broadcast", dist.broadcast(mine(a), src=src), a[src])
    check("scatter", dist.scatter(
        torch.zeros(rows, cols, device=dev),
        [t.to(dev, copy=True) for t in a] if r == 0 else None, src=0), a[r])
    check("alltoall", dist.alltoall([t.to(dev, copy=True) for t in m[r]]),
          m[:, r])
    check("psum", dist.psum(mine(a), "data"), a.sum(0), sum_tol)
    check("pmean", dist.pmean(mine(a), "data"), a.mean(0), sum_tol)
    check("pmax", dist.pmax(mine(a), "data"), a.amax(0))
    check("pmin", dist.pmin(mine(a), "data"), a.amin(0))
    check("ppermute", dist.ppermute(
        mine(a), "data", [(j, (j + 1) % n) for j in range(n)]),
        a[(r - 1) % n])
    check("all_to_all_single", dist.all_to_all_single(
        mine(c), "data", split_axis=0, concat_axis=1),
        torch.cat([c[j].chunk(n, 0)[r] for j in range(n)], 1))
    h = dist.collective.all_reduce_start(mine(a), "data")
    check("all_reduce_start_finish", dist.collective.all_reduce_finish(h),
          a.sum(0), sum_tol)
    dist.barrier()
    return {"errors": errs, "ranks": n}


def _dx_counters():
    from paddle_tpu_torch.ops import (flash_attention, layernorm_residual,
                                      softmax_cross_entropy)
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq)

    return {"flash_attention": flash_attention,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "layernorm_residual": layernorm_residual,
            "softmax_cross_entropy": softmax_cross_entropy}


def _dx_zero(counters):
    for c in counters.values():
        c.launches = 0
        if hasattr(c, "backward_launches"):
            c.backward_launches = 0


def _dx_read(counters):
    out = {k: c.launches for k, c in counters.items()}
    out["layernorm_residual_backward"] = \
        counters["layernorm_residual"].backward_launches
    return out


def _dx_steps(torch, model, ids, steps, cuda, first=None):
    """``steps`` train_batch calls on ``ids`` (the first one through
    ``first``, when given); the counters are zeroed after the first step
    and read after the last.  Returns (losses, seconds and launches of
    steps 2..)."""
    counters = _dx_counters()
    losses = [first() if first else model.train_batch([ids], [ids])[0]]
    if cuda:
        torch.cuda.synchronize()
    _dx_zero(counters)
    t0 = time.monotonic()
    for _ in range(steps - 1):
        losses.append(model.train_batch([ids], [ids])[0])
    if cuda:
        torch.cuda.synchronize()
    return losses, time.monotonic() - t0, _dx_read(counters)


def dx_hybrid(torch, conf):
    """DX2: the dryrun's first leg, sharding 2 x model 2 on 4 ranks."""
    import numpy as np

    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet

    c, dev = conf["dx2"], conf["device"]
    cuda = dev.startswith("cuda")
    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy(
        sharding_degree=2, mp_degree=2))
    net = _dx_gpt(torch, c["cfg"], "float32", dev)
    cfg = net.gpt.cfg
    opt = fleet.distributed_optimizer(ptt.optimizer.AdamW(
        learning_rate=c["lr"], weight_decay=0.01, multi_precision=True))
    model = ptt.Model(net).prepare(optimizer=opt, loss=net.loss)
    ids = _dx_ids(np, c["cfg"], c["B"], c["S"], SEED + 91)
    losses, wall, launches = _dx_steps(torch, model, ids, c["steps"], cuda)
    D, L = cfg.hidden_size, cfg.num_layers
    blk = net.gpt.blocks[0]
    shapes = {"qkv": list(blk.attn.qkv.weight.shape),
              "fc1": list(blk.mlp.fc1.weight.shape),
              "wte": list(net.gpt.wte.weight.shape),
              "qkv_moment1": list(opt._state["slots"][
                  "gpt.blocks.0.attn.qkv.weight"]["moment1"].shape)}
    # the TP weights hold out/2 columns (qkv's 3 fused blocks of D/2), the
    # table half the vocabulary; ZeRO: the slots half of that on dim 0
    assert shapes["qkv"] == [D, 3 * D // 2] and \
        shapes["fc1"] == [D, cfg.intermediate_size // 2], shapes
    assert shapes["wte"] == [cfg.vocab_size // 2, D], shapes
    assert shapes["qkv_moment1"] == [D // 2, 3 * D // 2], shapes
    steps = c["steps"] - 1
    if cuda:  # the CPU takes the plain versions: no launch
        assert launches["layernorm_residual"] == L * steps, launches
        assert launches["layernorm_residual_backward"] == L * steps, \
            launches
        assert launches["softmax_cross_entropy"] == steps, launches
    full = model._plan.gather_parameters()
    ref = torch.load(c["ref_path"])
    # the gathered parameters within 1e-4 of their rms, in L2 over all of
    # them (a zero-initialized bias alone is Adam's rounding noise: a
    # gradient that changes sign between steps turns a 1e-6 difference
    # into 1e-3 of its movement, on one rank or four); the worst tensor
    # and the key third of the qkv biases (zero gradient in exact
    # arithmetic) are reported beside it
    sq_err = sq_ref = 0.0
    worst, worst_name, key_bias = 0.0, "", 0.0
    for k, want in ref.items():
        got = full[k].float().cpu()
        d2, r2 = float((got - want).pow(2).sum()), float(want.pow(2).sum())
        sq_err, sq_ref = sq_err + d2, sq_ref + r2
        if r2 and (d2 / r2) ** 0.5 > worst:
            worst, worst_name = (d2 / r2) ** 0.5, k
        if k.endswith("attn.qkv.bias"):
            third = want.shape[0] // 3
            key_bias = max(key_bias, float(
                (got - want)[third:2 * third].abs().max()))
    param_err = (sq_err / sq_ref) ** 0.5
    assert param_err <= 1e-4, (param_err, worst_name, worst)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, c["ref_losses"])]
    assert max(rel) <= 1e-4, (losses, c["ref_losses"])
    del model, opt, net, full, ref
    return {"losses": losses, "loss_rel_err": max(rel),
            "param_rms_err": param_err, "worst_tensor_rms_err": worst,
            "worst_tensor": worst_name, "key_bias_max_err": key_bias, "shapes": shapes,
            "launches_per_step": {k: v / steps for k, v in launches.items()},
            "timed_steps": steps, "timed_seconds": wall,
            "steps_per_s": steps / wall, "mesh": dict(dist.get_mesh().shape)}


def dx_ring(torch, conf):
    """DX3: the sep leg, sep 2 x model 2, ring attention on 4 ranks; the
    first step's ring chunks recorded and held to their plain versions;
    then a Ulysses forward against the ring's."""
    import numpy as np

    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import sequence_parallel as sp
    import importlib

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    c, dev = conf["dx3"], conf["device"]
    cuda = dev.startswith("cuda")
    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy(
        sep_degree=2, mp_degree=2))
    mesh = dist.get_mesh()
    net = _dx_gpt(torch, c["cfg"], "bfloat16", dev,
                  sequence_parallel="ring")
    L = net.gpt.cfg.num_layers
    opt = fleet.distributed_optimizer(ptt.optimizer.AdamW(
        learning_rate=c["lr"], weight_decay=0.01, multi_precision=True))
    model = ptt.Model(net).prepare(optimizer=opt, loss=net.loss)
    ids = _dx_ids(np, c["cfg"], c["B"], c["S"], SEED + 91)
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = sp.flash_attention_fwd_lse, sp.flash_attention_bwd_chunk

    def rec_fwd(q, k, v, causal=False, sm_scale=None):
        out = fwd(q, k, v, causal=causal, sm_scale=sm_scale)
        calls["fwd"].append((q, k, v, causal, sm_scale, out))
        return out

    def rec_bwd(q, k, v, out, lse, do, causal=False, sm_scale=None,
                delta=None):
        got = bwd(q, k, v, out, lse, do, causal=causal, sm_scale=sm_scale,
                  delta=delta)
        calls["bwd"].append((q, k, v, out, lse, do, causal, sm_scale, delta,
                             got))
        return got

    def check_step():
        sp.flash_attention_fwd_lse, sp.flash_attention_bwd_chunk = (
            rec_fwd, rec_bwd)
        try:
            return model.train_batch([ids], [ids])[0]
        finally:
            sp.flash_attention_fwd_lse, sp.flash_attention_bwd_chunk = (
                fwd, bwd)

    losses, wall, launches = _dx_steps(torch, model, ids, c["steps"], cuda,
                                       first=check_step)
    # every chunk of the check step against the plain version on its own
    # inputs (out and lse; dq, dk, dv with the merged out / lse / delta)
    chunk_err = {"out": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    chunk_rel = 0.0
    with torch.no_grad():
        for q, k, v, causal, scale, (out, lse) in calls["fwd"]:
            ref, ref_lse = fa.flash_attention_fwd_lse_ref(q, k, v, causal,
                                                          scale)
            e, _ = flash_out_close(torch, out, ref, "bfloat16")
            torch.testing.assert_close(lse, ref_lse,
                                       **FLASH_LSE_TOL["bfloat16"])
            chunk_err["out"] = max(chunk_err["out"], e)
        for (q, k, v, out, lse, do, causal, scale, delta,
             got) in calls["bwd"]:
            ref = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                             scale, delta=delta)
            for name, g, r in zip(("dq", "dk", "dv"), got, ref):
                g, r = g.float(), r.float()
                rel = float((g - r).pow(2).sum().sqrt() / r.pow(2).sum().sqrt())
                assert rel <= RING_CHUNK_REL_L2 and bool(
                    torch.isfinite(g).all()), (name, rel)
                chunk_err[name] = max(chunk_err[name],
                                      float((g - r).abs().max()))
                chunk_rel = max(chunk_rel, rel)
    n_chunks = len(sp.ring_schedule(mesh.shape["sep"],
                                    mesh.axis_index("sep"), True))
    assert len(calls["fwd"]) == len(calls["bwd"]) == L * n_chunks, (
        len(calls["fwd"]), len(calls["bwd"]), L, n_chunks)
    del calls
    steps = c["steps"] - 1
    want = L * n_chunks * steps
    for k in ("flash_attention", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        # on the card each chunk is one launch; the CPU takes plain versions
        assert launches[k] == (want if cuda else 0), (k, launches[k], want)
    if cuda:
        assert launches["layernorm_residual"] == L * steps, launches
        assert launches["layernorm_residual_backward"] == L * steps, launches
        assert launches["softmax_cross_entropy"] == steps, launches
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, c["ref_losses"])]
    assert max(rel) <= 2e-2, (losses, c["ref_losses"])
    # Ulysses against the ring, on the trained weights, one forward of
    # the block stack each (the hidden states the LM head reads)
    net.eval()
    with torch.no_grad():
        x = torch.as_tensor(ids, device=dev)
        ring_logits = net.gpt(x)
        for blk in net.gpt.blocks:
            blk.attn.sequence_parallel = "ulysses"
        uly_logits = net.gpt(x)
    for blk in net.gpt.blocks:
        blk.attn.sequence_parallel = "ring"
    # two bf16 models that round their attention differently: the hidden
    # states' error in L2 within 2e-2 of their rms (the port's bf16
    # tolerance)
    e_uly, sq_err, sq_ref = 0.0, 0.0, 0.0
    for s in range(0, ring_logits.shape[1], 1024):  # bounded temporaries
        u, g = (t[:, s:s + 1024].float() for t in (uly_logits, ring_logits))
        e_uly = max(e_uly, float((u - g).abs().max()))
        sq_err += float((u - g).pow(2).sum())
        sq_ref += float(g.pow(2).sum())
    share = (sq_err / sq_ref) ** 0.5
    assert share <= 2e-2, share
    del ring_logits, uly_logits, model, opt, net
    return {"losses": losses, "loss_rel_err": max(rel),
            "chunks_a_layer": n_chunks, "sep_index": mesh.axis_index("sep"),
            "chunk_max_abs_err": chunk_err,
            "chunk_grad_rel_l2": chunk_rel,
            "ulysses_vs_ring_max_abs_err": e_uly,
            "ulysses_vs_ring_rel_l2": share,
            "launches_per_step": {k: v / steps for k, v in launches.items()},
            "timed_steps": steps, "timed_seconds": wall,
            "steps_per_s": steps / wall, "mesh": dict(mesh.shape)}


def dx_rank(conf):
    """One rank of the 4-rank world: DX1, DX2, DX3 in turn, each with its
    seconds, collective counts and this rank's peak device memory."""
    import torch

    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.distributed as dist

    dev = conf["device"]
    cuda = dev.startswith("cuda")
    ptt.set_device(dev)
    if cuda:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = {}
    for leg, fn in (("DX1", dx_collectives), ("DX2", dx_hybrid),
                    ("DX3", dx_ring)):
        dist.reset_collective_stats()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        res = fn(torch, conf)
        if cuda:
            torch.cuda.synchronize()
        res["seconds"] = time.monotonic() - t0
        res["collective_stats"] = dist.collective_stats()
        res["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
        out[leg] = res
        if dist.get_rank() == 0:
            log(f"{leg} rank 0: {res['seconds']:.1f}s")
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


def dx_data_parallel(conf):
    """DX4, one of 2 ranks: a conv net with SyncBatchNorm under
    DataParallel on this rank's half of a seeded global batch; its first
    step's gradients and batch-norm statistics against the same net (with
    BatchNorm2D) on the whole batch in this process; then timed steps."""
    import torch

    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.mesh import build_mesh, set_mesh

    dev, c = conf["device"], conf["dx4"]
    cuda = dev.startswith("cuda")
    ptt.set_device(dev)
    if cuda:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    set_mesh(build_mesh())
    dist.reset_collective_stats()
    n, r = dist.get_world_size(), dist.get_rank()
    gen = torch.Generator().manual_seed(SEED + 93)
    x = torch.randn(c["B"], c["C"], c["HW"], c["HW"], generator=gen)
    x += torch.arange(c["B"], dtype=torch.float32)[:, None, None, None] / 4
    y = torch.randint(0, 10, (c["B"],), generator=gen)

    def build(norm):
        ptt.seed(SEED)
        return nn.Sequential(nn.Conv2D(c["C"], c["F"], 3, padding=1),
                             norm(c["F"]), nn.ReLU(), nn.Flatten(),
                             nn.Linear(c["F"] * c["HW"] ** 2, 10)).to(dev)

    ref = build(nn.BatchNorm2D)
    F = torch.nn.functional
    F.cross_entropy(ref(x.to(dev)), y.to(dev)).backward()
    rows = slice(r * c["B"] // n, (r + 1) * c["B"] // n)
    t0 = time.monotonic()
    net = dist.DataParallel(build(nn.SyncBatchNorm))
    F.cross_entropy(net(x[rows].to(dev)), y[rows].to(dev)).backward()
    # against the largest gradient of all: the conv bias feeds a batch
    # norm, so its exact gradient is 0 and only rounding noise is left
    top = max(float(q.grad.abs().max()) for q in ref.parameters())
    errs = {k: float((p.grad - q.grad).abs().max()) / top
            for (k, p), (_, q) in zip(net._layers.named_parameters(),
                                      ref.named_parameters())}
    worst = max(errs.values())
    bn, bn_ref = net._layers[1], ref[1]
    stats = max(float((bn._mean - bn_ref._mean).abs().max()),
                float((bn._variance - bn_ref._variance).abs().max()))
    assert worst <= 1e-4, errs
    assert stats <= 1e-5, stats
    opt = ptt.optimizer.Momentum(learning_rate=0.01,
                                 parameters=list(net.parameters()))
    opt.step()
    opt.clear_grad()
    if cuda:
        torch.cuda.synchronize()
    t1 = time.monotonic()
    for _ in range(c["steps"]):
        F.cross_entropy(net(x[rows].to(dev)), y[rows].to(dev)).backward()
        opt.step()
        opt.clear_grad()
    if cuda:
        torch.cuda.synchronize()
    wall = time.monotonic() - t1
    return {"grad_rel_err": worst, "bn_stats_err": stats,
            "timed_steps": c["steps"], "timed_seconds": wall,
            "steps_per_s": c["steps"] / wall,
            "seconds": time.monotonic() - t0,
            "collective_stats": dist.collective_stats(),
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}


def dx_nccl(torch, gpu, conf):
    """DX0: the NCCL route at world size 1 on this process's card: every
    collective on card tensors, then ``fleet.init`` with every degree 1
    training gpt_small f32 (dropout 0.1) for 2 steps through
    ``train_batch``, bit for bit the plain ``train_batch``'s."""
    import numpy as np
    import torch.distributed as tdist

    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import build_mesh, set_mesh

    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    env = dist.init_parallel_env(backend="nccl")
    assert tdist.get_backend() == "nccl" and env.world_size == 1
    dist.reset_collective_stats()
    try:
        coll = dx_collectives(torch, conf)
        stats = dist.collective_stats()
        assert all(v["staged_bytes"] == 0 for v in stats.values()), stats
        ids = np.random.RandomState(SEED + 92).randint(
            0, 50304, size=(4, GPT_S)).astype(np.int32)
        runs = {}
        for route in ("plain", "fleet"):
            ptt.seed(SEED)
            net = _dx_gpt(torch, {}, "float32", conf["device"])
            opt = ptt.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                      multi_precision=True)
            if route == "fleet":
                fleet.init(is_collective=True,
                           strategy=fleet.DistributedStrategy())
                opt = fleet.distributed_optimizer(opt)
            model = ptt.Model(net).prepare(optimizer=opt, loss=net.loss)
            ptt.seed(SEED + 1)
            t1 = time.monotonic()
            losses = [model.train_batch([ids], [ids])[0] for _ in range(2)]
            torch.cuda.synchronize()
            runs[route] = dict(losses=losses, wall=time.monotonic() - t1,
                               params=[p.detach().clone() for p in
                                       net.parameters()],
                               plan=model._plan is not None)
            del model, opt, net
        assert runs["fleet"]["plan"] and not runs["plain"]["plan"]
        assert runs["fleet"]["losses"] == runs["plain"]["losses"], runs
        assert all(torch.equal(a, b) for a, b in zip(
            runs["fleet"]["params"], runs["plain"]["params"]))
        stats = dist.collective_stats()
    finally:
        fleet._initialized, fleet._strategy = False, None
        tdist.destroy_process_group()
        set_mesh(build_mesh())
    res = {"collective_errors": coll["errors"],
           "losses": runs["fleet"]["losses"], "bit_equal": True,
           "steps_per_s": 2 / runs["fleet"]["wall"],
           "seconds": time.monotonic() - t0, "collective_stats": stats,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"DX0[{gpu}]: nccl world 1: {len(coll['errors'])} collectives on "
        f"card tensors equal the stacked semantics (largest error "
        f"{max(coll['errors'].values()):.3e}); fleet.init(all degrees 1) "
        f"gpt_small f32 2 train_batch steps bit-equal to the plain path "
        f"(losses {runs['fleet']['losses']}); {res['seconds']:.1f}s, "
        f"{res['steps_per_s']:.2f} steps/s, peak "
        f"{res['peak_bytes'] / 2**20:.0f} MiB; collective_stats "
        f"{json.dumps(stats)}")
    return res


def dx_chunk_timing(torch, gpu, conf):
    """Kernels 4-6 at DX3's chunk shape ``[B, H/2, S/2, 64]`` bf16: a
    full (non-causal) ring chunk's forward, dq and dk / dv kernels beside
    the plain versions, the library (``scaled_dot_product_attention``,
    forward; its backward through ``autograd.grad``) and the bound,
    median (min-max) of 3 runs from CUDA events."""
    import importlib

    import torch.nn.functional as F

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    c = conf["dx3"]
    B, H, S, hd = c["B"], 12 // 2, c["S"] // 2, 64
    gen = torch.Generator().manual_seed(SEED + 94)
    scale = 1.0 / hd ** 0.5
    copies = []
    for _ in range(2):
        q, k, v, do, out, lse = bwd_inputs(torch, fa, B, H, S, S, hd,
                                           torch.bfloat16, gen,
                                           causal=False)
        copies.append((q, k, v, do, out, lse,
                       (do.float() * out.float()).sum(-1)))
    pairs = B * H * S * S
    n_qkv = B * H * S * hd * 2
    stats = 2 * B * H * S * 4
    iters = max(3, int(2e13 // (4.0 * pairs * hd)))
    with torch.no_grad():
        fwd = runs_ms(torch, lambda q, k, v, *_: fa.flash_attention_fwd_lse(
            q, k, v, False), copies, iters)
        fwd_plain = runs_ms(torch, lambda q, k, v, *_:
                            fa.flash_attention_fwd_lse_ref(q, k, v, False),
                            copies, max(2, iters // 10))
        fwd_lib = runs_ms(torch, lambda q, k, v, *_:
                          F.scaled_dot_product_attention(q, k, v), copies,
                          iters)
        dq = runs_ms(torch, lambda q, k, v, do, o, l, d:
                     fa.flash_attention_bwd_dq(q, k, v, do, l, d, False,
                                               scale, 0), copies, iters)
        dkv = runs_ms(torch, lambda q, k, v, do, o, l, d:
                      fa.flash_attention_bwd_dkv(q, k, v, do, l, d, False,
                                                 scale, 0), copies, iters)
        bwd_plain = runs_ms(torch, lambda q, k, v, do, o, l, d:
                            fa.flash_attention_bwd_ref(
                                q, k, v, o, l, do, False, delta=d),
                            copies, max(2, iters // 20))
    graphs = []
    for q, k, v, do, *_ in copies:
        ins = tuple(t.detach().requires_grad_() for t in (q, k, v))
        graphs.append((F.scaled_dot_product_attention(*ins), ins, do))
    bwd_lib = runs_ms(torch, lambda o, ins, do: torch.autograd.grad(
        o, ins, do, retain_graph=True), graphs, iters)
    rows = {}
    for key, ms, plain, lib, flops, nbytes in (
            ("fwd", fwd, fwd_plain, fwd_lib, 4.0 * pairs * hd,
             4 * n_qkv + B * H * S * 4),
            ("dq", dq, bwd_plain, bwd_lib, 6.0 * pairs * hd,
             5 * n_qkv + stats),
            ("dkv", dkv, bwd_plain, bwd_lib, 8.0 * pairs * hd,
             6 * n_qkv + stats)):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        rows[key] = dict(ms=ms[0], ms_range=[ms[1], ms[2]],
                         plain_ms=plain[0], library_ms=lib[0],
                         bound_ms=max(t_b, t_o) * 1e3,
                         bound_by="bytes" if t_b >= t_o else "operations",
                         shape=[B, H, S, hd], dtype="bfloat16",
                         causal=False)
        log(f"timing[{gpu}] DX3 ring chunk {key} bf16 non-causal "
            f"[{B}, {H}, {S}, {hd}]: kernel {_spread(ms)} ms = "
            f"{flops / ms[0] / 1e9:.1f} TFLOP/s, plain {_spread(plain)} ms, "
            f"library {_spread(lib)} ms, bound {rows[key]['bound_ms']:.4f} "
            f"ms by {rows[key]['bound_by']}")
    del copies, graphs
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _dx_line(gpu, leg, per_rank):
    mb = [round(r["peak_bytes"] / 2**20) for r in per_rank]
    log(f"{leg}[{gpu}]: {len(per_rank)} ranks sharing the card over gloo "
        f"(times measure kernels and host, no interconnect): seconds "
        f"{[round(r['seconds'], 2) for r in per_rank]}, steps/s "
        f"{[round(r.get('steps_per_s', 0.0), 3) for r in per_rank]}, peak "
        f"MiB per rank {mb}; collective_stats rank 0 "
        f"{json.dumps(per_rank[0]['collective_stats'])}")


def dx_launches(dx, name, legs=("DX2", "DX3")):
    """``{leg: [launches a timed step, rank by rank]}`` of one kernel."""
    return {leg: [r["launches_per_step"][name] for r in dx[leg]]
            for leg in legs}


def distributed_phases(torch, gpu, conf=None):
    """DX0-DX4 (see the module docstring); returns their records for the
    kernels line and the ``{"distributed": ...}`` line."""
    import tempfile

    from paddle_tpu_torch.distributed import spawn

    conf = conf or dx_conf()
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share this card
    log(f"DX: this process holds {torch.cuda.memory_allocated() / 2**20:.0f}"
        f" MiB of the card before the ranks start")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dx_")
    try:
        t0 = time.monotonic()
        refs = dx_references(torch, gpu, conf, workdir)
        conf["dx2"].update(ref_path=refs["dx2"]["path"],
                           ref_losses=refs["dx2"]["losses"])
        conf["dx3"]["ref_losses"] = refs["dx3"]["losses"]
        world = spawn(dx_rank, (conf,), nprocs=DX_RANKS, backend="gloo",
                      timeout=DX_TIMEOUT).results
        log(f"DX1-DX3: the 4-rank world in {time.monotonic() - t0:.1f}s "
            f"(references included)")
    finally:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    dx1 = [w["DX1"] for w in world]
    _dx_line(gpu, "DX1", dx1)
    log(f"DX1[{gpu}]: {len(dx1[0]['errors'])} collectives on card tensors, "
        f"each rank's slot = the stacked result; largest error "
        f"{max(max(d['errors'].values()) for d in dx1):.3e}")
    dx2 = [w["DX2"] for w in world]
    _dx_line(gpu, "DX2", dx2)
    log(f"DX2[{gpu}]: gpt_small f32 sharding 2 x model 2, "
        f"{conf['dx2']['B']}x{conf['dx2']['S']}: losses {dx2[0]['losses']} "
        f"(one rank {conf['dx2']['ref_losses']}, rel err "
        f"{max(d['loss_rel_err'] for d in dx2):.2e}); gathered parameters "
        f"rms err {max(d['param_rms_err'] for d in dx2):.2e} of the rms; "
        f"local shapes {dx2[0]['shapes']}; launches a step "
        f"{dx2[0]['launches_per_step']}")
    dx3 = [w["DX3"] for w in world]
    _dx_line(gpu, "DX3", dx3)
    log(f"DX3[{gpu}]: sep 2 x model 2 ring, {conf['dx3']['B']}x"
        f"{conf['dx3']['S']} bf16: losses {dx3[0]['losses']} (one rank "
        f"{conf['dx3']['ref_losses']}, rel err "
        f"{max(d['loss_rel_err'] for d in dx3):.2e}); chunks a layer per "
        f"rank {[d['chunks_a_layer'] for d in dx3]}; launches a step per "
        f"rank {[d['launches_per_step'] for d in dx3]}; chunk errors vs "
        f"plain {[d['chunk_max_abs_err'] for d in dx3]} (gradients' L2 "
        f"{max(d['chunk_grad_rel_l2'] for d in dx3):.2e} of the plain "
        f"ones'); Ulysses vs ring "
        f"hidden states max err "
        f"{max(d['ulysses_vs_ring_max_abs_err'] for d in dx3):.3e}, L2 "
        f"{max(d['ulysses_vs_ring_rel_l2'] for d in dx3):.2e} of theirs")
    dx4 = spawn(dx_data_parallel, (conf,), nprocs=2, backend="gloo",
                timeout=DX_TIMEOUT).results
    _dx_line(gpu, "DX4", dx4)
    log(f"DX4[{gpu}]: DataParallel + SyncBatchNorm, 2 ranks: gradients "
        f"{max(d['grad_rel_err'] for d in dx4):.2e} of the largest from the "
        f"whole batch's, statistics err "
        f"{max(d['bn_stats_err'] for d in dx4):.2e}")
    dx0 = dx_nccl(torch, gpu, conf)
    chunk = dx_chunk_timing(torch, gpu, conf)
    rec = {"device": gpu, "DX0": dx0, "DX1": dx1, "DX2": dx2, "DX3": dx3,
           "DX4": dx4, "ring_chunk_timing": chunk,
           "references": {k: {"losses": v["losses"],
                              "seconds": v["seconds"]}
                          for k, v in refs.items()}}
    log(json.dumps({"distributed": rec}, default=float))
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import _build

    gpu = gpu_line()
    log(gpu)  # name, power limit: as nvidia-smi prints them
    start = _START[0] = time.monotonic()

    def mark(phases):
        log(f"smoke: {phases} begin at {time.monotonic() - start:.1f}s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    sources = sorted(p[:-3] for p in os.listdir(_build.CSRC)
                     if p.endswith(".cu"))
    t0 = time.monotonic()
    libs = _build.build(*sources)
    log(f"build: {sources} with {_build.nvcc()} {' '.join(_build.NVCC_FLAGS)}"
        f" in {time.monotonic() - t0:.1f}s")
    for name, so in libs.items():
        for line in so.with_suffix(".log").read_text().splitlines():
            # C75xx: ptxas serialized a wgmma (a slow kernel, not a wrong one)
            if "registers" in line or "spill" in line or "C75" in line:
                log(f"build[{name}]: {line.strip()}")

    mark("serving (3-5, Q1-Q4, D1-D5)")
    max_err = check_kernels(torch)
    model = build_serve_model(torch)
    before = fingerprint(torch, model)
    submark("served")
    served = serve(torch, gpu, model)
    submark("rows")
    rows = timing(torch, gpu)
    log(f"serve[{gpu}]: launches per decode step / admission = "
        f"{served['launches_per_call']:.0f}")
    submark("qmm_errs")
    qmm_errs = check_quantized_matmul(torch)
    qpaged_err = check_kernels_quantized(torch)
    submark("qserved")
    qserved = {mode: serve(torch, gpu, model, quantized=mode)
               for mode in QUANT_MODES}
    assert fingerprint(torch, model) == before, \
        "the float model changed under a quantized engine"
    log("serve: the float model is bit-identical after both quantized "
        "engines")
    # the default serving engines, the hand-off and the swaps
    submark("d1")
    d1, d1_outs = serve_dense(torch, gpu, model)
    submark("d2")
    d2, _ = serve_dense(torch, gpu, model, continuous=False,
                        d1_outs=d1_outs)
    submark("d3")
    d3 = bench_generate(torch, gpu)
    submark("d4")
    d4 = {mode or "float": handoff(torch, gpu, model, quantized=mode)
          for mode in (None, "int8")}
    submark("d5")
    d5 = weight_swaps(torch, gpu)
    log(json.dumps({"serving_engines": {
        "device": gpu, "dense_continuous": d1, "legacy": d2,
        "bench_gpt_generate": d3, "handoff": d4, "weight_swaps": d5}}))
    del model
    submark("qrows")
    qrows = timing_quantized(torch, gpu)
    for name, r in (("float", served), *qserved.items()):
        log(f"engines[{gpu}] {name}: {r['tokens_per_s']:.1f} tokens/s, mean "
            f"latency {r['mean_ms']:.1f} ms, p99 {r['p99_ms']:.1f} ms, peak "
            f"device memory {r['peak_bytes'] / 2**20:.0f} MiB; launches per "
            f"call: paged_flash_decode {r['launches_per_call']:.0f}, "
            f"quantized_matmul {r['qmm_launches_per_call']:.0f}")
    mark("training (6-10)")
    errs = check_train_kernels(torch)
    bert = train_bert(torch, gpu)
    train_gpt(torch, gpu)
    card_vs_cpu(torch)
    trows = timing_train(torch, gpu)
    mark("ResNet-50 (R1-R5)")
    rerrs = check_resnet_kernels(torch)
    check_resnet_tail_grads(torch)
    resnet = train_resnet(torch, gpu)
    resnet_card_vs_cpu(torch)
    rrows = timing_resnet(torch, gpu)
    mark("long context (L1-L4, W)")
    flash_err = check_flash_kernel(torch)
    long = long_context_inference(torch, gpu)
    long_context_card_vs_cpu(torch)
    frows = timing_flash(torch, gpu)
    wide = check_width_repairs(torch, gpu)
    mark("long-context training (LT1-LT4)")
    bwd_errs = check_flash_bwd_kernels(torch)
    train_long = long_context_training(torch, gpu)
    long_context_train_card_vs_cpu(torch)
    brows = timing_flash_bwd(torch, gpu)
    mark("MoE (M1-M5)")
    gmm_err, gs_train = check_grouped_matmul(torch)
    moe_train = train_moe(torch, gpu)
    moe_card_vs_cpu(torch)
    moe_served = serve(torch, gpu, moe_model(
        torch, "float32", moe_capacity_factor=MOE_SERVE_CF))
    for name, r in (("float", served), ("moe", moe_served)):
        log(f"engines[{gpu}] {name}: {r['tokens_per_s']:.1f} tokens/s, mean "
            f"latency {r['mean_ms']:.1f} ms, p99 {r['p99_ms']:.1f} ms, peak "
            f"device memory {r['peak_bytes'] / 2**20:.0f} MiB; launches per "
            f"call: paged_flash_decode {r['launches_per_call']:.0f}, "
            f"grouped_matmul {r['gmm_launches_per_call']:.0f}")
    mrows = timing_gmm(torch, gpu, gs_train)
    mark("training loop (F1-F4)")
    ln_mixed = check_ln_mixed(torch, gpu)
    fit = fit_bert(torch, gpu)
    fit_card_vs_cpu(torch)
    f16 = f16_scaler_loop(torch, gpu)
    # sparse CTR training: no kernel of ops/ is on this path (in the JAX
    # package it is plain XLA), so the kernels line below does not change
    mark("sparse CTR (S1-S4)")
    sparse_rules_card_vs_cpu(torch)
    ctr = ctr_main_path(torch, gpu)
    ctr_bench_config5(torch, gpu)
    vocab = vocab_independence(torch, gpu)
    log(json.dumps({"sparse_ctr": {
        "device": gpu, "main_path": ctr, "vocab_independence": vocab}}))
    # k training steps an execution as one CUDA graph
    # (steps_per_execution), then the tensor API
    mark("k-step graph (K1-K5, T1)")
    k1 = graph_vs_eager(torch, gpu)
    k2 = ctr_graph_main_path(torch, gpu, ctr)
    k3 = resnet_graph(torch, gpu, resnet)
    k4 = bert_graph(torch, gpu, bert)
    k5 = resnet18_example(torch, gpu)
    t1 = tensor_api_card(torch, gpu)
    log(json.dumps({"steps_per_execution": {
        "device": gpu, "graph_vs_eager": k1, "sparse_ctr": k2,
        "resnet50": k3, "bert_base": k4, "resnet18_example": k5,
        "tensor_api": t1}}))
    # bench.py's configs 1-3 through the 1.x static graph (ST1-ST5)
    mark("static graph (ST1-ST5)")
    st = static_graph_phases(torch, gpu, bert, resnet, k3, k4)
    # batched multi-LoRA and multi-tenant serving (kernel 10 on both
    # low-rank hops of every adapted linear)
    mark("multi-LoRA (A1-A5)")
    lora = lora_phases(torch, gpu)
    # the layer library: the long-document encoder through kernels 4-6
    # (non-causal), recompute, nn.Transformer, the LSTM LM, beam search
    mark("layer library (N1-N7)")
    nn = nn_phases(torch, gpu)
    # MoE and quantization wherever the JAX package runs them: MoE in the
    # dense engines, quantized MoE, BERT MoE, quantized BERT (kernels 9
    # and 10 at new shapes), ResNet-50 PTQ and MobileNetV2 QAT (kernel 9
    # under the int8 layers)
    mark("MoE and quantization (E1-E5, C1-C3)")
    comp = compression_phases(torch, gpu, d1, moe_served)
    # the vision slice: the new convolutions and pools card vs CPU, and
    # ResNet-50 trained from image files through fit (kernels 7 and 8)
    mark("vision (V1-V4)")
    vis = vision_phases(torch, gpu)
    # the detection slice: the new ops card vs CPU and the sweep kernel,
    # Faster R-CNN R50-C4 training (kernels 7 and 8 in its backbone and
    # RoI head) and inference, the static names
    mark("detection (B1-B4)")
    dets = detection_phases(torch, gpu)
    # the sequence-tagging slice: the new ops card vs CPU, LAC's BiGRU-CRF
    # through the static graph, a BERT-base CRF tagger (kernel 2 24 + 24
    # a step), the 1.x builders
    mark("sequence tagging (SQ1-SQ4)")
    tags = tagging_phases(torch, gpu)
    # the distributed slice: collectives, DataParallel + SyncBatchNorm,
    # gpt_small at sharding 2 x model 2 and the sep leg's ring attention
    # (kernels 4-6 per chunk) as ranks sharing the card over gloo; the NCCL
    # route at world size 1
    mark("distributed (DX0-DX4)")
    dx = distributed_phases(torch, gpu)
    paged = dict(name="paged_flash_decode", route="cuda",
                 source="paddle_tpu_torch/ops/csrc/paged_attention.cu",
                 replaces="paddle_tpu/ops/paged_attention.py:155")
    # T = 1 decode shape; the quantized branch's numbers are the int8
    # pool's, its launches those of the int8 and fp8 engines together
    # (since the serving-engines slice) the launches of the hand-off's
    # prefill and decode engines (D4) and of bench.py's paged run (D3)
    kernels = [
        dict(paged, branch="float pools", launches=served["launches"],
             max_abs_err=max_err, **rows[1],
             handoff_launches={k: v["paged_flash_decode"] for k, v in
                               d4["float"]["launches"].items()},
             bench_paged_launches=d3["paged_launches"],
             # held to the plain version at the shapes D3 and D4 ran
             path_checks={
                 "D3": d3["path_checks"]["paged_flash_decode"],
                 "D4[float]": d4["float"]["path_checks"][
                     "paged_flash_decode"]}),
        dict(paged, branch="quantized pools (int8, fp8) with scale planes",
             launches=sum(r["launches"] for r in qserved.values()),
             max_abs_err=qpaged_err, **qrows[("paged", "int8", 1)],
             handoff_launches={k: v["paged_flash_decode"] for k, v in
                               d4["int8"]["launches"].items()},
             path_checks={"D4[int8]": d4["int8"]["path_checks"][
                 "paged_flash_decode"]})]
    # the main path's numbers: BERT-base pretraining's shapes, device time
    # of the forward and (under "backward") of the backward kernel; the
    # GPT, long-context and phase W shapes beside them
    ln_rows = {k: dict(v) for k, v in trows.items()
               if k[0] == "layernorm_residual"}
    for (_, name), row in ln_rows.items():
        row["max_abs_err"] = errs[("layernorm_residual", name)]
        row["backward"] = dict(
            row["backward"],
            max_abs_err=errs[("layernorm_residual_backward", name)])
    ln_bert = ln_rows.pop(("layernorm_residual", "bert"))
    ln_bert["backward"]["launches"] = bert["launches"][
        "layernorm_residual_backward"]
    kernels.append(dict(
        name="layernorm_residual", route="cuda",
        source="paddle_tpu_torch/ops/csrc/fused_layernorm.cu",
        replaces="paddle_tpu/ops/fused_layernorm.py:68",
        launches=bert["launches"]["layernorm_residual"], **ln_bert,
        other_shapes={
            **{f"{dtype} [{M}, {D}]": ln_rows[("layernorm_residual", name)]
               for name, dtype, M, D, _ in LN_SHAPES[1:]},
            **{f"{dtype} {list(WIDE_LN)} (phase W)": wide[dtype]
               for dtype in ("float32", "bfloat16")}},
        train_batch_hidden_1024={
            k: v for k, v in wide.items() if k.startswith(
                ("launches", "backward_launches"))},
        # the mixed dtypes amp hands it (phase F1) and the launches of the
        # training-loop slice (F2: Model.fit under O1; F4: float16)
        mixed_dtypes=ln_mixed,
        fit_o1_launches=fit["launches"]["layernorm_residual"],
        fit_o1_backward_launches=fit["launches"][
            "layernorm_residual_backward"],
        float16_loop_launches=f16["launches"],
        # a replayed K4 execution (4 steps): 24 forward and 24 backward a
        # step, counted per replay
        graph_launches=k4["graph_launches"]["layernorm_residual"],
        graph_backward_launches=k4["graph_launches"][
            "layernorm_residual_backward"],
        # a replayed ST3 window (bench.py config 3 through run_steps, 10
        # steps): 24 forward and 24 backward a step
        static_launches=st["bert"]["launches"]["layernorm_residual"],
        static_backward_launches=st["bert"]["launches"][
            "layernorm_residual_backward"],
        # SQ3: the BERT-base CRF tagger's timed steps (24 + 24 a step), and
        # each shape of its check step held to plain on the path's inputs
        tagging_launches=tags["SQ3"]["launches"],
        tagging_path_checks=tags["SQ3"]["kernel_path_checks"],
        # DX2 / DX3: every rank's GPT step, forward (backward the same)
        distributed_launches_per_step=dx_launches(dx, "layernorm_residual")))
    kernels.append(dict(
        name="softmax_cross_entropy", route="cuda",
        source="paddle_tpu_torch/ops/csrc/fused_softmax_xent.cu",
        replaces="paddle_tpu/ops/fused_softmax_xent.py:85",
        launches=bert["launches"]["softmax_cross_entropy"],
        max_abs_err=errs[("softmax_cross_entropy", "bert")],
        **trows[("softmax_cross_entropy", "bert")],
        # GPT's float32 logits, and BERT's float32 ones under amp O1 (F2)
        other_shapes={
            f"{dtype} [{M}, {V}]" + (" (amp O1, phase F2)"
                                     if name == "bert_o1" else ""):
            dict(trows[("softmax_cross_entropy", name)],
                 max_abs_err=errs[("softmax_cross_entropy", name)])
            for name, dtype, M, V in SX_SHAPES[1:]},
        fit_o1_launches=fit["launches"]["softmax_cross_entropy"],
        graph_launches=k4["graph_launches"]["softmax_cross_entropy"],
        static_launches=st["bert"]["launches"]["softmax_cross_entropy"],
        distributed_launches_per_step=dx_launches(
            dx, "softmax_cross_entropy")))
    # the decode shape of the widest linear (fc1, M = 8), int8; launches
    # of the int8 and fp8 engines together; fp8 and fc2's decode and
    # admission shapes beside them
    kernels.append(dict(
        name="quantized_matmul", route="cuda",
        source="paddle_tpu_torch/ops/csrc/quantized_matmul.cu",
        replaces="paddle_tpu/ops/quantized_matmul.py:70",
        launches=sum(r["qmm_launches"] for r in qserved.values()),
        max_abs_err=max(qmm_errs.values()),
        **qrows[("qmm", "int8", "fc1", 8)],
        # the quantized dense engine (D5) and the int8 hand-off (D4)
        dense_engine_launches=d5["int8"]["quantized_matmul_launches"],
        handoff_launches={k: v["quantized_matmul"] for k, v in
                          d4["int8"]["launches"].items()},
        # held to the plain version at the shapes D4 and D5 ran
        path_checks={"D4[int8]": d4["int8"]["path_checks"][
            "quantized_matmul"], "D5[int8]": d5["int8"]["path_checks"][
                "quantized_matmul"]},
        other_shapes={f"{mode} {name} M={M}": qrows[("qmm", mode, name, M)]
                      for mode, name, M in (
                          ("fp8", "fc1", 8), ("fp8", "fc2", 8),
                          ("fp8", "fc2", 384), ("int8", "fc2", 8),
                          ("int8", "fc2", 384))},
        # the MoE / quantization slice: quantized MoE engines (E3: qkv and
        # out, 24 a call), quantized BERT-base (E5: 48 a forward), the
        # int8 layers of ResNet-50 PTQ (C2) and MobileNetV2 QAT (C3: the
        # depthwise layers take the exact grouped route, not the kernel);
        # C1's shapes timed, and every shape the paths gave it held
        compression_launches={
            **{f"E3[{k}]": (v["qmm_launches"] if k.startswith("paged")
                            else v["quantized_matmul_launches"])
               for k, v in comp["E"]["E3"].items()},
            **{f"E5[{m}]": comp["E5"][m]["launches"]["quantized_matmul"]
               for m in QUANT_MODES},
            "C2": comp["C2"]["launches"], "C3": comp["C3"]["launches"]},
        compression_path_checks={
            "E5": comp["E5"]["path_checks"].get("quantized_matmul"),
            "C2": comp["C2"]["path_checks"].get("quantized_matmul"),
            "C3": comp["C3"]["path_checks"].get("quantized_matmul")},
        compression_shapes=comp["C1"]))
    # ResNet-50 config 2: launches of the timed training steps, numbers at
    # layer1's conv3 shape (the largest), bf16, the Hopper designs' device
    # time; the other conv3 shapes beside them
    k7_err = max(e for (_, dt, design), e in rerrs.items()
                 if dt == "bfloat16" and design == "wgmma")
    for i, (name, line, err) in enumerate((
            ("conv1x1_bn_stats", 107, k7_err), ("bn_apply_relu", 203, 0.0))):
        kernels.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/ops/csrc/fused_conv1x1_bn.cu",
            replaces=f"paddle_tpu/ops/fused_conv1x1_bn.py:{line}",
            launches=resnet["launches"][name], max_abs_err=err,
            graph_launches=k3["graph_launches"][name],
            # a replayed ST4 window (bench.py config 2, 60 steps)
            static_launches=st["resnet"]["launches"][name],
            # V2: ResNet-50 from image files through fit, per step
            vision_launches=[c[i] for c in vis["V2"]["launches_per_step"]],
            # B2: Faster R-CNN R50-C4 training (13 in the C4 backbone, 3 in
            # the res5 RoI head), per step; each shape of its check step
            # held to the plain version on the path's own inputs
            detection_launches=[c[i] for c in
                                dets["B2"]["launches_per_step"]],
            detection_path_checks=dets["B2"]["kernel_path_checks"][name],
            **rrows[(name, "layer1")],
            other_shapes={layer: rrows[(name, layer)]
                          for layer, _, _, _ in RESNET_TAILS[1:]}))
    # the long-context inference slice: launches of its eval_batch and
    # predict_batch calls, numbers at its shape, bf16, causal
    # the layer library's encoder (N2: 5 train_batch steps; N3: one
    # recomputed step and 3 fit executions of 2 steps) and the non-causal
    # shape it runs (N1: errors, CUDA-graph times, bounds)
    n1t = nn["N1"]["timing"]

    def noncausal(key, err):
        return dict(max_abs_err=err, **{k: n1t[key][k] for k in (
            "ms", "ms_range", "plain_ms", "library_ms", "bound_ms",
            "bound_by")}, shape=[NN_B, NN_HEADS, NN_S, NN_D // NN_HEADS],
            dtype="bfloat16")

    def nn_launches(i):
        return {"N2": list(nn["N2"]["launches"].values())[i],
                "N3_recompute_step": nn["N3"]["launches_with"][i],
                "N3_fit_graph": nn["N3"]["graph_launches"][i]}

    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="paddle_tpu_torch/ops/csrc/flash_attention.cu",
        replaces="paddle_tpu/ops/flash_attention.py:193",
        launches=long["launches"], max_abs_err=flash_err,
        **frows["slice"], nn_launches=nn_launches(0),
        noncausal=noncausal("fwd", nn["N1"]["max_abs_err"]["fwd"]),
        # DX3: the ring's launches a step per rank (the non-skipped chunks
        # of JAX's schedule x 12 layers) and a full chunk's numbers
        ring_launches_per_step=dx_launches(dx, "flash_attention", ("DX3",)),
        ring_chunk=dict(dx["ring_chunk_timing"]["fwd"], max_abs_err=max(
            d["chunk_max_abs_err"]["out"] for d in dx["DX3"]))))
    # the long-context training slice: launches of its timed train_batch
    # steps, numbers at its shape, bf16, causal; plain_ms and library_ms
    # are whole backwards (dq, dk and dv together), for both kernels
    for name, key, line in (("flash_attention_bwd_dq", "dq", 387),
                            ("flash_attention_bwd_dkv", "dkv", 463)):
        kernels.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            replaces=f"paddle_tpu/ops/flash_attention.py:{line}",
            launches=train_long["launches"][name],
            max_abs_err=bwd_errs[key], **brows["slice"][key],
            whole_backward_ms=brows["slice"]["bwd_ms"],
            nn_launches=nn_launches(1 if key == "dq" else 2),
            noncausal=noncausal(key, max(
                nn["N1"]["max_abs_err"][g] for g in (
                    ("dq",) if key == "dq" else ("dk", "dv")))),
            ring_launches_per_step=dx_launches(dx, name, ("DX3",)),
            ring_chunk=dict(dx["ring_chunk_timing"][key], max_abs_err=max(
                d["chunk_max_abs_err"][g] for d in dx["DX3"]
                for g in (("dq",) if key == "dq" else ("dk", "dv"))))))
    # the MoE slice: launches of its timed train_batch steps, numbers at the
    # slice's fc1 shape (bf16, a real routing); fc2 and the serving decode
    # shapes (float32) beside them
    kernels.append(dict(
        name="grouped_matmul", route="cuda",
        source="paddle_tpu_torch/ops/csrc/grouped_matmul.cu",
        replaces="paddle_tpu/ops/grouped_matmul.py:62",
        launches=moe_train["launches"]["grouped_matmul"],
        max_abs_err=gmm_err, **mrows["train_fc1"],
        other_shapes={k: v for k, v in mrows.items() if k != "train_fc1"},
        serving_launches=moe_served["gmm_launches"],
        # the LoRA slice: both hops of every adapted linear (A2-A5), its
        # shapes held in A1 and by phase, timed at the decode / admission
        # hops
        lora_launches={
            "A2": lora["A2"]["launches"], "A3": lora["A3"]["launches"],
            "A4": {k: lora["A4"][k]["launches"]
                   for k in ("dense", "legacy", "int8")},
            "A5": lora["A5"]["launches"]},
        lora_path_checks=dict(A1=lora["A1"], **lora["path"]),
        lora_shapes=lora["rows"],
        # the MoE / quantization slice: the dense engines (E1, E2), the
        # quantized MoE engines (E3) and BERT-base MoE training (E4: 24 a
        # step), each shape the paths gave it held to the plain version
        compression_launches={
            "E1": comp["E"]["E1"]["grouped_matmul_launches"],
            "E1[legacy]": comp["E"]["E1_legacy"]["grouped_matmul_launches"],
            "E2": comp["E"]["E2"]["grouped_matmul_launches"],
            **{f"E3[{k}]": (v["gmm_launches"] if k.startswith("paged")
                            else v["grouped_matmul_launches"])
               for k, v in comp["E"]["E3"].items()},
            "E4": comp["E4"]["launches"]["grouped_matmul"]},
        compression_path_checks={
            "E1-E3": comp["E"]["path_checks"].get("grouped_matmul"),
            "E4": comp["E4"]["path_checks"].get("grouped_matmul")}))
    # the greedy NMS sweep (no TPU kernel behind it): B2's launches, its
    # numbers at the training proposals' shape (2 images, k = 12000)
    kernels.append(dict(
        name="nms_sweep", route="cuda",
        source="paddle_tpu_torch/ops/csrc/nms_sweep.cu",
        replaces="none (paddle_tpu/nn/functional/detection.py:340, nms's "
                 "lax.fori_loop; no Pallas kernel)",
        launches=sum(c[2] for c in dets["B2"]["launches_per_step"]),
        # the keep masks as 0 / 1: 0.0 where they are equal
        max_abs_err=float(any(v["differ"] for v in
                              dets["B1"]["sweeps"].values())),
        differing_decisions=sum(v["differ"] for v in
                                dets["B1"]["sweeps"].values()),
        worst_distance=max(v["worst_distance"] for v in
                           dets["B1"]["sweeps"].values()),
        **{k: dets["B1"]["sweep_timing"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        shape=dets["B1"]["sweep_timing"]["shape"],
        inference_launches_per_pass=dets["B3"]["sweep_launches_per_pass"]))
    mark("the records")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
