"""The distributed slice on the card (``gpu`` marker; skipped without
one; this file imports no JAX): a 2-rank world sharing cuda:0 over gloo
(every collective staged through pinned host buffers) and a 1-rank NCCL
world, each running collectives on card tensors and ring attention over
``sep`` = the world through kernels 4-6 (``torch_dist_workers.card_world``).
Collectives exact against the stacked sums (1e-5); ring attention bf16
against the plain float32 whole-sequence attention within 3e-2 of the
largest magnitude (forward and the gradients of ``sum(out * do)``);
kernel 4 / 5 / 6 launches = the ring schedule's chunks (2 ranks: 1 and 2;
1 rank: the whole-sequence call, 1 each).

Run on the card: ``python -m pytest -m gpu tests/test_torch_distributed_card.py``.
"""
import pytest
import torch

from paddle_tpu_torch.distributed import spawn

import torch_dist_workers as W


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: ranks on cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("backend,ranks", [("gloo", 2), ("nccl", 1)])
def test_collectives_and_ring_on_the_card(card, backend, ranks):
    results = spawn(W.card_world, (), nprocs=ranks, backend=backend,
                    timeout=600).results
    for r, res in enumerate(results):
        assert res["all_reduce_err"] <= 1e-5 and res["all_gather_err"] == 0
        staged = sum(v["staged_bytes"] for v in res["stats"].values())
        assert (staged > 0) == (backend == "gloo"), res["stats"]
        chunks = r + 1 if ranks == 2 else 1
        assert res["launches"] == [chunks] * 3, res["launches"]
        assert res["out_err"] <= 3e-2, res
        assert max(res["grad_errs"]) <= 3e-2, res
