"""The port's ``nn.recompute`` on the CPU: with dropout active, every
policy (none, dots, dots_saveable, everything_saveable, a callable) gives
the loss and gradients of the same step without recompute bit for bit,
and the marked block's forward runs twice (the forward and its
recomputation); under amp O1 too; ``apply_recompute`` by class name and by
the repeated-block default; the functional ``recompute``; nested blocks;
``train_batch`` steps with and without recompute bit-equal; with dropout
off, the port's recomputed encoder against the JAX package's at rtol /
atol 2e-5.  ``gpu``-marked: a k-step CUDA-graph replay of a recomputed
step equals its eager steps on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tpt
import paddle_tpu_torch.nn as tnn
from paddle_tpu.nn import functional_call
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from torch_nn_pairs import bridged, jax_params

D, H, FF, B, S = 32, 4, 64, 2, 8


def _encoder(seed=5, dropout=0.1, layers=2, device="cpu"):
    tpt.seed(seed)
    enc = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        D, H, FF, dropout=dropout, attn_dropout=dropout), layers)
    head = tnn.Linear(D, 7)
    return tnn.Sequential(enc, head).to(device)


def _x(seed=0):
    return torch.tensor(np.random.RandomState(seed).randn(B, S, D)
                        .astype(np.float32))


def _step(net, x, seed=11):
    """One training forward + backward from ``seed``: (loss, grads)."""
    net.train()
    tpt.seed(seed)
    loss = net(x).square().mean() + net(x * 0.5).mean()
    grads = torch.autograd.grad(loss, list(net.parameters()))
    return loss.detach(), grads


def _count_linear1(net):
    calls = []
    for m in net.modules():
        if type(m).__name__ == "TransformerEncoderLayer":
            m.linear1.register_forward_hook(lambda *a: calls.append(1))
            break
    return calls


POLICIES = [None, "none", "dots", "dots_saveable", "everything_saveable",
            lambda ctx, op, *a, **k: torch.utils.checkpoint.CheckpointPolicy
            .PREFER_RECOMPUTE]


@pytest.mark.parametrize("policy", POLICIES, ids=[
    "default", "none", "dots", "dots_saveable", "everything_saveable",
    "callable"])
def test_every_policy_keeps_loss_and_grads_with_dropout(policy):
    x = _x()
    ref_loss, ref_grads = _step(_encoder(), x)
    net = _encoder()
    calls = _count_linear1(net)
    assert tnn.apply_recompute(net, ["TransformerEncoderLayer"],
                               policy=policy) == 2
    loss, grads = _step(net, x)
    assert torch.equal(loss, ref_loss)
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g, r)
    # two forwards (x and x / 2) then their recomputations in the backward
    assert len(calls) == 4


def test_forward_runs_twice_and_unmark_restores():
    net = _encoder()
    calls = _count_linear1(net)
    layer = net[0].layers[0]
    tnn.mark_recompute(layer)
    tnn.mark_recompute(layer)  # idempotent
    tpt.seed(1)
    net.train()
    net(_x()).sum().backward()
    assert len(calls) == 2
    tnn.unmark_recompute(layer)
    assert "forward" not in layer.__dict__
    calls.clear()
    net(_x()).sum().backward()
    assert len(calls) == 1


def test_default_targets_are_the_repeated_blocks():
    net = _encoder(layers=3)
    assert tnn.apply_recompute(net) == 3  # the LayerList's three layers
    assert all(getattr(m, "_recompute_wrapped", False)
               for m in net[0].layers)


def test_functional_recompute_and_policy_errors():
    lin = tnn.Linear(D, D)
    x = _x().requires_grad_()
    tpt.seed(2)
    a = tnn.functional.dropout(lin(x), 0.3)
    ga = torch.autograd.grad(a.sum(), [x, lin.weight])
    tpt.seed(2)
    b = tnn.recompute(lambda t: tnn.functional.dropout(lin(t), 0.3), x,
                      policy="dots")
    gb = torch.autograd.grad(b.sum(), [x, lin.weight])
    assert torch.equal(a, b)
    for u, v in zip(ga, gb):
        assert torch.equal(u, v)
    with pytest.raises(InvalidArgumentError):
        tnn.recompute(lin, x, policy="sometimes")


def test_nested_blocks_keep_loss_and_grads():
    x = _x()
    ref_loss, ref_grads = _step(_encoder(), x)
    net = _encoder()
    tnn.apply_recompute(net, ["TransformerEncoderLayer", "MultiHeadAttention",
                              "TransformerEncoder"])
    loss, grads = _step(net, x)
    assert torch.equal(loss, ref_loss)
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g, r)


def test_amp_o1_recompute_equals_no_recompute():
    x = _x()

    def run(recompute):
        net = _encoder()
        if recompute:
            tnn.apply_recompute(net, ["TransformerEncoderLayer"])
        net.train()
        tpt.seed(4)
        with auto_cast(level="O1"):
            loss = net(x).float().square().mean()
        return loss.detach(), torch.autograd.grad(loss,
                                                  list(net.parameters()))

    (l0, g0), (l1, g1) = run(False), run(True)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def _mse(out, y):
    return ((out - y) ** 2).mean()


def test_train_batch_steps_bit_equal_with_and_without_recompute():
    rng = np.random.RandomState(3)
    xs = rng.randn(3, B, S, D).astype(np.float32)
    ys = rng.randn(3, B, S, 7).astype(np.float32)

    def train(recompute):
        net = _encoder()
        if recompute:
            tnn.apply_recompute(net, ["TransformerEncoderLayer"])
        m = tpt.Model(net, inputs=["x"], labels=["y"])
        m.prepare(optimizer=tpt.optimizer.AdamW(
            1e-3, parameters=net.parameters()), loss=_mse)
        tpt.seed(9)
        losses = [m.train_batch([x], [y])[0] for x, y in zip(xs, ys)]
        return losses, {k: p.detach().clone()
                        for k, p in net.named_parameters()}

    (l0, p0), (l1, p1) = train(False), train(True)
    assert l0 == l1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_recomputed_encoder_as_jax_without_dropout():
    jpt.seed(6)
    jenc = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(
        D, H, FF, dropout=0.0), 2)
    tenc = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        D, H, FF, dropout=0.0), 2)
    bridged(jenc, tenc)
    jnn.apply_recompute(jenc, ["TransformerEncoderLayer"])
    tnn.apply_recompute(tenc, ["TransformerEncoderLayer"])
    x = np.random.RandomState(1).randn(B, S, D).astype(np.float32)
    jp = jax_params(jenc)
    jloss, jg = jax.value_and_grad(lambda p: jnp.sum(jnp.square(
        functional_call(jenc, p, jnp.asarray(x)))))(
            {k: jnp.asarray(v) for k, v in jp.items()})
    tenc.train()
    tl = tenc(torch.tensor(x)).square().sum()
    tg = dict(zip([n for n, _ in tenc.named_parameters()],
                  torch.autograd.grad(tl, list(tenc.parameters()))))
    np.testing.assert_allclose(float(tl.detach()), float(jloss), rtol=2e-5)
    for k, v in jg.items():
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(v), rtol=2e-5,
                                   atol=2e-5, err_msg=k)


# -- on the card: the recomputed step inside a CUDA graph -------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a k-step CUDA-graph replay of a "
                    "recomputed step against eager steps")
    return torch.device("cuda")


@pytest.mark.gpu
def test_recompute_graph_replay_equals_eager_steps_on_the_card():
    dev = _card()
    rng = np.random.RandomState(4)
    batches = [(rng.randn(B, S, D).astype(np.float32),
                rng.randn(B, S, 7).astype(np.float32)) for _ in range(6)]

    def model(k):
        net = _encoder(device=dev)
        tnn.apply_recompute(net, ["TransformerEncoderLayer"])
        m = tpt.Model(net, inputs=["x"], labels=["y"])
        m.prepare(optimizer=tpt.optimizer.AdamW(
            1e-3, parameters=net.parameters()), loss=_mse,
            steps_per_execution=k)
        return net, m

    torch.use_deterministic_algorithms(True)
    try:
        enet, eager = model(1)
        tpt.seed(12)
        el = [eager.train_batch([x], [y])[0] for x, y in batches]
        gnet, graph = model(2)
        tpt.seed(12)
        gl = torch.cat([graph._train_batches_device(batches[i:i + 2])
                        for i in range(0, 6, 2)]).tolist()
    finally:
        torch.use_deterministic_algorithms(False)
    assert graph._graph_steps.captures >= 1
    assert gl == el
    for (k, a), b in zip(enet.named_parameters(), gnet.parameters()):
        assert torch.equal(a, b), k
