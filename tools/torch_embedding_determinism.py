"""Is torch's embedding backward reproducible on the card at ST3's tables?

For each table of config 3's BERT-base embeddings (the 2 token types, the
128 positions, the 30522 words) at 256 x 128 ids, as ``chip_smoke.py``
ST3 feeds them, runs the backward of ``F.embedding`` ``--reps`` times in
bfloat16 and in float32, eagerly and as a CUDA graph replay, and counts
the results that differ from the first eager one.  Once with torch's
default algorithms and once under ``torch.use_deterministic_algorithms``.
Prints the card (``nvidia-smi`` name and power limit) and one JSON line a
case.

    python3 tools/torch_embedding_determinism.py [--reps 200]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

B, S, D = 256, 128, 768


def tables(rng):
    return (("token_type", 2, (rng.uniform(size=(B, S)) < 0.5)),
            ("position", 128, np.tile(np.arange(S), (B, 1))),
            ("word", 30522, rng.randint(0, 30522, (B, S))))


def differing(ids, weight, grad_out, reps):
    """(eager, replay): how many of ``reps`` backward results differ from
    the first eager one."""
    def backward():
        return torch.autograd.grad(F.embedding(ids, weight), weight,
                                   grad_out)[0]

    first = backward()
    eager = sum(not torch.equal(backward(), first) for _ in range(reps))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        backward()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = backward()
    replay = 0
    for _ in range(reps):
        graph.replay()
        replay += not torch.equal(captured, first)
    return eager, replay


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_embedding_determinism: no CUDA card visible",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda:0")
    for deterministic in (False, True):
        torch.use_deterministic_algorithms(deterministic)
        rng = np.random.RandomState(0)
        for name, rows, ids in tables(rng):
            ids = torch.from_numpy(np.asarray(ids, np.int64)).to(dev)
            for dtype in (torch.bfloat16, torch.float32):
                w = torch.randn(rows, D, device=dev).to(dtype)
                go = torch.randn(B, S, D, device=dev).to(dtype)
                eager, replay = differing(ids, w.requires_grad_(), go,
                                          args.reps)
                print(json.dumps({
                    "table": name, "rows": rows, "dtype": str(dtype)[6:],
                    "deterministic_algorithms": deterministic,
                    "reps": args.reps, "eager_differ": eager,
                    "replay_differ": replay, "torch": torch.__version__}),
                    flush=True)
    torch.use_deterministic_algorithms(False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
