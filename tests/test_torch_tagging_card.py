"""The sequence-tagging slice on the card (``gpu`` marker; skipped without
one): ``chip_smoke.py``'s SQ1 op checks and SQ3's kernel-2 path check at
small sizes, held to the port's own CPU results (this file imports no
JAX).

* The CRF (loss and its gradients, Viterbi scores and paths,
  ``crf_decoding``'s agreement mask) and the sequence ops on the card
  against the CPU on one seeded float32 input, TF32 off: outputs and the
  gradients of ``Σ out · c`` within 1e-4 of the CPU result's rms, indices
  equal (a differing Viterbi path only where the CPU scores both paths
  within 1e-5 relative).
* ``hash`` on the card bit-equal to the CPU over the full int64 range;
  ``beam_search`` equal.
* A small BERT CRF tagger's ``Model.train_batch`` step on the card: kernel
  2 one forward and one backward launch a LayerNorm, and every launch's
  outputs equal to the plain versions on its inputs (phase 6's
  tolerances).

Run on the card: ``python -m pytest -m gpu tests/test_torch_tagging_card.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.fluid import layers as L
from paddle_tpu_torch.nn import functional as F

TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tagging ops against the CPU")
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


def _err(got, ref):
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    rms = float(ref.pow(2).mean().sqrt()) or 1.0
    return float((got - ref).abs().max()) / rms


def _pair(dev, fn, arrays, grad=()):
    """``fn`` on the CPU and on the card: float outputs within TOL of the
    CPU rms, the rest equal, then the gradients of ``Σ out[0] · c``."""
    cpu = [a.clone().requires_grad_(i in grad) for i, a in enumerate(arrays)]
    gpu = [a.to(dev).requires_grad_(i in grad) for i, a in enumerate(arrays)]
    oc, og = fn(*cpu), fn(*gpu)
    oc = oc if isinstance(oc, tuple) else (oc,)
    og = og if isinstance(og, tuple) else (og,)
    for c, g in zip(oc, og):
        if c.is_floating_point():
            assert _err(g, c) <= TOL
        else:
            assert torch.equal(g.cpu(), c)
    if grad:
        cot = torch.randn(oc[0].shape, generator=torch.Generator()
                          .manual_seed(1))
        gc = torch.autograd.grad((oc[0] * cot).sum(), [cpu[i] for i in grad])
        gg = torch.autograd.grad((og[0] * cot.to(dev)).sum(),
                                 [gpu[i] for i in grad])
        for c, g in zip(gc, gg):
            assert _err(g, c) <= TOL


def _lengths(gen, B, T):
    ln = torch.randint(1, T + 1, (B,), generator=gen)
    ln[0], ln[1] = 1, T
    return ln


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(48, 64, 57), (32, 128, 7)])
def test_crf_on_the_card_against_the_cpu(card, shape):
    B, T, D = shape
    gen = torch.Generator().manual_seed(B)
    e = torch.randn(B, T, D, generator=gen)
    tr = torch.randn(D + 2, D, generator=gen)
    y = torch.randint(0, D, (B, T), generator=gen)
    ln = _lengths(gen, B, T)
    _pair(card, F.linear_chain_crf, [e, tr, y, ln], grad=(0, 1))
    pg, sg = F.viterbi_decode(e.to(card), tr.to(card), ln.to(card))
    pc, sc = F.viterbi_decode(e, tr, ln)
    assert _err(sg, sc) <= TOL
    assert torch.equal(pg.cpu(), pc)  # random scores: no tie
    agree = F.crf_decoding(e.to(card), tr.to(card), y.to(card), ln.to(card))
    mask = torch.arange(T)[None] < ln[:, None]
    assert torch.equal(agree.cpu(), torch.where(mask, (pc == y).long(), 0))


SEQUENCE = {
    "pool_max": (lambda x, ln: F.sequence_pool(x, "max", lengths=ln), (0,)),
    "pool_sqrt": (lambda x, ln: F.sequence_pool(x, "sqrt", lengths=ln),
                  (0,)),
    "softmax": (lambda x, ln: F.sequence_softmax(x[..., 0], lengths=ln),
                (0,)),
    "reverse": (lambda x, ln: F.sequence_reverse(x, lengths=ln), (0,)),
    "pad": (lambda x, ln: F.sequence_pad(x, 0.5, maxlen=70, lengths=ln),
            (0,)),
    "expand": (lambda x, ln: F.sequence_expand(x[:, 0], ln), (0,)),
    "reshape": (lambda x, ln: F.sequence_reshape(x, 16, lengths=ln), (0,)),
    "concat": (lambda x, ln: F.sequence_concat([x, x[:, :8]],
                                               lengths=[ln, ln.clamp(
                                                   max=8)]), (0,)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SEQUENCE))
def test_sequence_op_on_the_card_against_the_cpu(card, name):
    gen = torch.Generator().manual_seed(len(name))
    x = torch.randn(40, 64, 32, generator=gen)
    fn, grad = SEQUENCE[name]
    _pair(card, fn, [x, _lengths(gen, 40, 64)], grad=grad)


@pytest.mark.gpu
def test_hash_and_beam_search_on_the_card(card):
    gen = torch.Generator().manual_seed(3)
    keys = torch.randint(-2 ** 63, 2 ** 63 - 1, (500, 3), generator=gen,
                         dtype=torch.int64)
    for size, num in ((1000, 2), (2 ** 40 + 7, 1)):
        assert torch.equal(L.hash(keys.to(card), size, num).cpu(),
                           L.hash(keys, size, num))
    W, K = 4, 4
    pre_ids = torch.randint(0, 8, (16 * W, 1), generator=gen)
    pre_ids[::5] = 9
    args = [pre_ids, torch.randn(16 * W, 1, generator=gen),
            torch.randint(0, 8, (16 * W, K), generator=gen),
            torch.randn(16 * W, K, generator=gen)]
    got = L.beam_search(*[a.to(card) for a in args], W, 9,
                        return_parent_idx=True)
    want = L.beam_search(*args, W, 9, return_parent_idx=True)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_bert_crf_tagger_step_runs_kernel_2_as_plain(card):
    """A 2-layer BERT (hidden 128) CRF tagger, one train_batch step: 4
    forward and 4 backward kernel-2 launches, each launch's outputs equal
    to the plain versions on its inputs."""
    import chip_smoke as cs
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import bert_tiny
    from paddle_tpu_torch.ops import layernorm_residual

    cfg = bert_tiny(hidden_size=128, num_heads=2, intermediate_size=256,
                    max_position=128)
    ptt.seed(0)
    net = cs.bert_crf_tagger(torch, cfg, "cuda")
    model = ptt.Model(net, ["ids", "mask"], ["tags", "lengths"]).prepare(
        optimizer=ptt.optimizer.AdamW(learning_rate=2e-5,
                                      multi_precision=True),
        loss=net.loss)
    inputs, labels = cs.sq3_batch(np, cfg.vocab_size, 0)
    calls = []
    layernorm_residual.launches = layernorm_residual.backward_launches = 0
    with cs.recording_ln_kernels(calls):
        loss = model.train_batch(inputs, labels)[0]
    torch.cuda.synchronize()
    assert np.isfinite(loss)
    assert layernorm_residual.launches == 4
    assert layernorm_residual.backward_launches == 4
    rows = cs.check_path_ln_kernels(torch, calls, "card test")
    assert sum(r["calls"] for r in rows) == 8
