#!/usr/bin/env python3
"""The sparse CTR step of one tree, for A/B calls on the card:

    for t in chip_scratch/before . . chip_scratch/before; do
        python3 tools/torch_sparse_step_ab.py $t; done

Imports ``paddle_tpu_torch`` from ROOT (a checkout, or a copy of the
package in a gitignored directory), trains ``chip_smoke.py`` S2's
``WideDeep`` (1M ids, dim 32, lazy Adam) on 200 seeded numpy batches of
256 and prints one ``AB {...}`` line: the median synchronized step (steps
20-200) and the mean step of 100 more, synchronized only at the end (S4's
method).  Run the trees in turns in one call: the step is bound by the
host, whose speed differs between calls."""
import json, os, sys, time
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
import numpy as np
import torch
import paddle_tpu_torch as ptt
assert os.path.dirname(ptt.__file__).startswith(root)
from paddle_tpu_torch.models import WideDeep

rng = np.random.RandomState(400)
table = rng.randn(1_000_000)
w_dense = rng.randn(8) * 0.5
batches = []
for _ in range(300):
    ids = rng.randint(0, 1_000_000, (256, 8)).astype(np.int64)
    xd = rng.randn(256, 8).astype(np.float32)
    s = 2.0 * (table[ids[:, 0]] + xd @ w_dense)
    y = (rng.uniform(size=256) < 1 / (1 + np.exp(-s))).astype(np.float32)
    batches.append((ids, xd, y[:, None]))
ptt.seed(0)
net = WideDeep(num_fields=8, vocab_size=1_000_000, embed_dim=32, dense_dim=8,
               hidden_sizes=(64, 32), sparse=True)
model = ptt.Model(net, inputs=["sparse", "dense"], labels=["label"])
model.prepare(optimizer=ptt.optimizer.Adam(1e-3, lazy_mode=True), loss=net.loss)
step_s = []
for ids, xd, y in batches[:200]:
    t0 = time.perf_counter()
    model.train_batch([ids, xd], [y])
    step_s.append(time.perf_counter() - t0)
torch.cuda.synchronize()
t0 = time.perf_counter()
for ids, xd, y in batches[200:]:
    model._train_batch_device([ids, xd], [y])
torch.cuda.synchronize()
unsync = (time.perf_counter() - t0) / 100 * 1e3
print("AB", json.dumps({"tree": sys.argv[1], "median_sync_ms": float(np.median(step_s[20:])) * 1e3,
                        "mean_unsync_ms": unsync}), flush=True)
