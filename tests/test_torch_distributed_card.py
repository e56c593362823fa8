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

The pipeline and the expert axis (``torch_dist_workers.card_parallel_world``,
2 ranks sharing cuda:0): a narrow f32 GPT's step through the 1F1B
pipeline (pipe 2, 4 microbatches) and an MoE GPT's at expert 2, each
against one rank's plain step on the card from the same seed — loss
rtol 1e-5, parameters 1e-5 in relative L2, and the gradients the
optimizer is handed (a rank's shards against the same slices of the plain
step's: Adam's first step moves each element by lr whatever the
gradient's size, so the parameters alone would not see a wrong one) 1e-4
in relative L2 — with kernel 2 at 2 blocks x
4 microbatches a stage rank, kernel 3 at 4 on the last stage and 0 on
the first, kernel 10 at 2 x 4 layers a forward on every rank.

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


@pytest.mark.gpu
def test_pipeline_check_step_on_the_card(card):
    results = spawn(W.card_parallel_world, ("pipeline",), nprocs=2,
                    backend="gloo", timeout=600).results
    for res in results:
        print(f"pipeline: loss {res['loss']} (one rank {res['ref_loss']}), "
              f"parameters {res['param_rel_l2']:.3e}, gradients "
              f"{res['grad_rel_l2']:.3e} in relative L2")
        assert abs(res["loss"] - res["ref_loss"]) <= 1e-5 * res["ref_loss"]
        assert res["param_rel_l2"] <= 1e-5, res
        assert res["grad_rel_l2"] <= 1e-4 and res["grads_held"], res
        assert res["launches"]["layernorm_residual"] == 2 * 4, res
        assert res["launches"]["softmax_cross_entropy"] == \
            (4 if res["stage"] == 1 else 0), res


@pytest.mark.gpu
def test_expert_axis_check_step_on_the_card(card):
    results = spawn(W.card_parallel_world, ("expert",), nprocs=2,
                    backend="gloo", timeout=600).results
    for res in results:
        print(f"expert: loss {res['loss']} (one rank {res['ref_loss']}), "
              f"parameters {res['param_rel_l2']:.3e}, gradients "
              f"{res['grad_rel_l2']:.3e} in relative L2")
        assert abs(res["loss"] - res["ref_loss"]) <= 1e-5 * res["ref_loss"]
        assert res["param_rel_l2"] <= 1e-5, res
        assert res["grad_rel_l2"] <= 1e-4 and res["grads_held"], res
        assert res["launches"]["grouped_matmul"] == 2 * 4, res
