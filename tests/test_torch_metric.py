"""The port's ``metric`` held against the JAX package's ``paddle_tpu.metric``
on the same seeded inputs, exactly: ``Accuracy`` (top-1, top-1/5;
``compute`` → ``update`` → ``accumulate`` over several batches, and the
names), ``Precision``, ``Recall``, ``Auc`` (and ``bucket_auc``'s
degenerate case), the functional ``accuracy``, ``chunk_eval`` in every
scheme (with excluded types and ragged lengths) and ``mean_iou`` (its
counts exact, its float32 mean within one ulp: the sum of the per-class
IoUs runs in another order).  The port takes tensors (a bf16 one too)
where JAX takes arrays.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.metric as jm
import paddle_tpu_torch.metric as tm


def _scores(seed, n=37, c=11):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, c).astype(np.float32),
            rng.randint(0, c, size=(n, 1)).astype(np.int64))


@pytest.mark.parametrize("topk", [1, (1, 5)])
def test_accuracy_matches_jax(topk):
    t, j = tm.Accuracy(topk=topk), jm.Accuracy(topk=topk)
    for seed in range(3):
        pred, label = _scores(seed)
        ct = t.compute(torch.from_numpy(pred), torch.from_numpy(label))
        cj = j.compute(pred, label)
        np.testing.assert_array_equal(ct, np.asarray(cj))
        np.testing.assert_array_equal(t.update(ct), j.update(cj))
    np.testing.assert_array_equal(t.accumulate(), j.accumulate())
    assert t.name() == j.name()
    t.reset()
    assert t.accumulate() == (0.0 if topk == 1 else [0.0, 0.0])


def test_accuracy_takes_bf16_scores():
    pred, label = _scores(4)
    # scores exact in bf16: the same top-k either way
    pred = torch.from_numpy(pred).to(torch.bfloat16)
    got = tm.Accuracy(topk=(1, 5)).compute(pred, torch.from_numpy(label))
    want = jm.Accuracy(topk=(1, 5)).compute(pred.float().numpy(), label)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_recall_match_jax(cls):
    t, j = getattr(tm, cls)(), getattr(jm, cls)()
    rng = np.random.RandomState(1)
    for _ in range(3):
        p = rng.rand(50).astype(np.float32)
        lab = rng.randint(0, 2, size=(50, 1))
        t.update(torch.from_numpy(p), torch.from_numpy(lab))
        j.update(p, lab)
    assert t.accumulate() == j.accumulate() and t.name() == j.name()
    t.reset()
    assert t.accumulate() == 0.0


@pytest.mark.parametrize("two_column", [False, True])
def test_auc_matches_jax(two_column):
    t, j = tm.Auc(num_thresholds=255), jm.Auc(num_thresholds=255)
    rng = np.random.RandomState(2)
    for _ in range(4):
        p = rng.rand(64).astype(np.float32)
        lab = (rng.rand(64) < p).astype(np.int64)
        if two_column:
            p = np.stack([1 - p, p], axis=1)
        t.update(torch.from_numpy(p), lab)
        j.update(p, lab)
    assert t.accumulate() == j.accumulate() and t.name() == j.name()
    assert tm.bucket_auc([0, 3], [0, 0]) == jm.bucket_auc([0, 3], [0, 0])
    assert tm.bucket_auc([1, 0], [0, 1], degenerate=0.5) == \
        jm.bucket_auc([1, 0], [0, 1], degenerate=0.5)


@pytest.mark.parametrize("k", [1, 3])
def test_functional_accuracy_matches_jax(k):
    pred, label = _scores(5)
    got = tm.accuracy(torch.from_numpy(pred), torch.from_numpy(label), k=k)
    want = jm.accuracy(pred, label, k=k)
    assert got.dtype == torch.float32
    assert float(got) == float(want)


@pytest.mark.parametrize("scheme,types", [("IOB", 3), ("IOE", 3),
                                          ("IOBES", 2), ("plain", 4)])
def test_chunk_eval_matches_jax(scheme, types):
    n_tags = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    rng = np.random.RandomState(6)
    hi = types * n_tags + 1
    pred = rng.randint(0, hi, size=(4, 20))
    lab = np.where(rng.rand(4, 20) < 0.7, pred, rng.randint(0, hi, (4, 20)))
    lengths = np.array([20, 13, 7, 1])
    for kw in ({}, {"excluded_chunk_types": [1]}, {"seq_length": lengths}):
        got = tm.chunk_eval(torch.from_numpy(pred), lab, scheme, types, **kw)
        want = jm.chunk_eval(pred, lab, scheme, types, **kw)
        for a, b in zip(got, want):
            assert a == b and type(a) is type(b), (kw, got, want)


def test_mean_iou_matches_jax():
    rng = np.random.RandomState(7)
    pred = rng.randint(0, 6, size=(3, 40))
    lab = rng.randint(0, 6, size=(3, 40))
    lab[0, :5] = pred[0, :5]
    # class 5 never appears: left out of the mean in both
    pred[pred == 5] = 4
    lab[lab == 5] = 4
    got = tm.mean_iou(torch.from_numpy(pred), torch.from_numpy(lab), 6)
    want = jm.mean_iou(pred, lab, 6)
    assert got[0].dtype == torch.float32
    # the per-class IoUs are exact; their sum is float32 in another order
    # (XLA adds them one by one, torch's reduction pairs them): one ulp
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=2 ** -23,
                               atol=0)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_metrics_alias_module():
    from paddle_tpu_torch.metric import metrics

    assert metrics.Accuracy is tm.Accuracy
    with pytest.raises(AttributeError):
        metrics.NotAMetric
