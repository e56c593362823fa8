"""The port's ``io`` (datasets, samplers, ``DataLoader``) held against the
JAX package's ``paddle_tpu.io``, index for index and value for value.

Orders are host numpy in both packages, so with an int seed (or no
shuffle) they must be identical: every dataset, every sampler
(``RandomSampler`` with an int seed, with and without replacement;
``WeightedRandomSampler`` from one numpy global seed), the batch samplers
(``drop_last`` both ways; ``DistributedBatchSampler`` at each rank,
shuffled and not), ``DataLoader`` batches in sync mode and with worker
processes, ``superbatch`` stacking (a short last batch flushes its group),
and exact resume: ``state_dict`` mid-epoch, a fresh loader restored from
it, the same remaining batches as the uninterrupted run — and as JAX's
restored loader.  The port stages batches as tensors on ``places``
(``"cpu"`` here); JAX's as device arrays; values compare exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu_torch as tpt
import paddle_tpu_torch.io as tio
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               UnimplementedError)


def _arrays(n=23, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, 3).astype(np.float32),
            rng.randint(0, 10, size=(n,)).astype(np.int64)]


class _Stream:
    """An iterable dataset for both packages (instances of each package's
    base class are built by ``_stream``)."""

    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.float32(i), np.int64(2 * i)


def _stream(io, n):
    cls = type("S", (_Stream, io.IterableDataset), {})
    return cls(n)


def _as_np(batch):
    if isinstance(batch, dict):
        return {k: _as_np(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return [_as_np(v) for v in batch]
    if isinstance(batch, torch.Tensor):
        return batch.numpy()
    return np.asarray(batch)


def _assert_same(a, b):
    a, b = _as_np(a), _as_np(b)
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    else:
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def _datasets(io):
    a = _arrays()
    td = io.TensorDataset(a)
    out = {
        "tensor": td,
        "compose": io.ComposeDataset([td, io.TensorDataset(_arrays(seed=1))]),
        "concat": io.ConcatDataset([td, io.TensorDataset(_arrays(5, 2))]),
        "subset": io.Subset(td, [4, 0, 22, 7]),
    }
    return out


@pytest.mark.parametrize("name", ["tensor", "compose", "concat", "subset"])
def test_map_datasets_match_jax(name):
    t, j = _datasets(tio)[name], _datasets(jio)[name]
    assert len(t) == len(j)
    for i in list(range(len(j))) + [-1]:
        _assert_same(t[i], j[i])


def test_chain_dataset_and_iterable_errors_match_jax():
    t = list(tio.ChainDataset([_stream(tio, 3), _stream(tio, 2)]))
    j = list(jio.ChainDataset([_stream(jio, 3), _stream(jio, 2)]))
    _assert_same(t, j)
    for io in (tio, jio):
        with pytest.raises(TypeError):
            len(_stream(io, 3))
        with pytest.raises(TypeError):
            _stream(io, 3)[0]
    with pytest.raises(InvalidArgumentError):
        tio.TensorDataset([np.zeros(3), np.zeros(4)])


def test_tensor_dataset_takes_tensors():
    ds = tio.TensorDataset([torch.arange(6).reshape(3, 2)])
    np.testing.assert_array_equal(ds[1][0], [2, 3])


def test_random_split_is_a_seeded_partition():
    ds = tio.TensorDataset(_arrays())
    a = tio.random_split(ds, [10, 13], generator=torch.Generator()
                         .manual_seed(3))
    b = tio.random_split(ds, [10, 13], generator=torch.Generator()
                         .manual_seed(3))
    assert a[0].indices == b[0].indices and a[1].indices == b[1].indices
    assert sorted(a[0].indices + a[1].indices) == list(range(23))
    tpt.seed(11)
    c = tio.random_split(ds, [10, 13])
    tpt.seed(11)
    assert tio.random_split(ds, [10, 13])[0].indices == c[0].indices
    with pytest.raises(InvalidArgumentError):
        tio.random_split(ds, [10, 12])


@pytest.mark.parametrize("kind", ["sequence", "random", "random_replace",
                                  "random_num_samples", "weighted",
                                  "weighted_no_replace"])
def test_samplers_match_jax_index_for_index(kind):
    def build(io):
        ds = io.TensorDataset(_arrays())
        if kind == "sequence":
            return io.SequenceSampler(ds)
        if kind == "random":
            return io.RandomSampler(ds, generator=7)
        if kind == "random_replace":
            return io.RandomSampler(ds, replacement=True, num_samples=40,
                                    generator=7)
        if kind == "random_num_samples":
            return io.RandomSampler(ds, num_samples=9, generator=7)
        w = np.linspace(0.1, 2.0, 23)
        return io.WeightedRandomSampler(w, 12,
                                        replacement=kind == "weighted")

    t, j = build(tio), build(jio)
    for epoch in range(2):  # an int seed moves on each epoch
        np.random.seed(epoch)
        ti = list(t)
        np.random.seed(epoch)
        assert ti == list(j), epoch
        assert len(t) == len(j) == len(ti)


def test_weighted_sampler_takes_an_explicit_generator():
    w = np.linspace(0.1, 2.0, 23)
    a = list(tio.WeightedRandomSampler(w, 12, generator=4))
    np.random.seed(4)
    assert a == list(jio.WeightedRandomSampler(w, 12))


def test_default_shuffle_replays_under_seed():
    ds = tio.TensorDataset(_arrays())
    tpt.seed(5)
    a = list(tio.RandomSampler(ds))
    tpt.seed(5)
    assert list(tio.RandomSampler(ds)) == a
    assert sorted(a) == list(range(23))


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_batch_samplers_match_jax(drop_last, shuffle):
    def build(io):
        ds = io.TensorDataset(_arrays())
        sampler = (io.RandomSampler(ds, generator=3) if shuffle
                   else io.SequenceSampler(ds))
        return io.BatchSampler(sampler=sampler, batch_size=5,
                               drop_last=drop_last)

    t, j = build(tio), build(jio)
    assert list(t) == list(j) and len(t) == len(j)
    assert list(t) == list(j)  # the next epoch too


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("rank", [0, 1, 2])
def test_distributed_batch_sampler_matches_jax(rank, shuffle):
    def build(io):
        return io.DistributedBatchSampler(io.TensorDataset(_arrays()), 4,
                                          num_replicas=3, rank=rank,
                                          shuffle=shuffle)

    t, j = build(tio), build(jio)
    for epoch in (0, 1):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        assert list(t) == list(j) and len(t) == len(j)
    with pytest.raises(UnimplementedError, match="distributed execution"):
        tio.DistributedBatchSampler(tio.TensorDataset(_arrays()), 4)


def _loader(io, **kw):
    ds = io.TensorDataset(_arrays())
    if io is tio:
        kw.setdefault("places", "cpu")
    return io.DataLoader(ds, batch_size=5, **kw)


@pytest.mark.parametrize("kw", [{}, {"drop_last": True},
                                {"use_buffer_reader": False},
                                {"return_numpy": True}],
                         ids=["staged", "drop_last", "no_buffer", "numpy"])
def test_dataloader_batches_match_jax(kw):
    t, j = _loader(tio, **kw), _loader(jio, **kw)
    tb, jb = list(t), list(j)
    assert len(tb) == len(jb) == len(t)
    if not kw.get("return_numpy"):
        assert all(isinstance(x, torch.Tensor) for b in tb for x in b)
    _assert_same(tb, jb)


def test_dataloader_stages_onto_places_and_default_needs_a_card():
    (x, y), = list(tio.DataLoader(tio.TensorDataset(_arrays(4)),
                                  batch_size=4, places=["cpu"]))
    assert x.device.type == "cpu" and x.dtype == torch.float32
    if not torch.cuda.is_available():
        from paddle_tpu_torch.framework.errors import UnavailableError
        with pytest.raises(UnavailableError):
            next(iter(tio.DataLoader(tio.TensorDataset(_arrays(4)))))


def test_worker_mode_equals_sync_mode():
    sync = list(_loader(tio, shuffle=False))
    workers = list(_loader(tio, num_workers=2, prefetch_factor=2))
    _assert_same(workers, sync)


def test_iterable_dataset_loader_matches_jax():
    t = list(tio.DataLoader(_stream(tio, 7), batch_size=3, places="cpu"))
    j = list(jio.DataLoader(_stream(jio, 7), batch_size=3))
    _assert_same(t, j)
    t = list(tio.DataLoader(_stream(tio, 7), batch_size=3, drop_last=True,
                            return_numpy=True))
    assert len(t) == 2


def test_staging_thread_error_reaches_the_consumer():
    class Bad(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("boom")
            return np.float32(i)

    it = iter(tio.DataLoader(Bad(), batch_size=2, places="cpu"))
    next(it)
    with pytest.raises(KeyError, match="boom"):
        next(it)


@pytest.mark.parametrize("drop_last", [False, True])
def test_superbatch_stacking_matches_jax(drop_last):
    kw = dict(superbatch=2, drop_last=drop_last)
    t, j = list(_loader(tio, **kw)), list(_loader(jio, **kw))
    _assert_same(t, j)
    # 23 rows / 5: 4 full batches and a short one, which flushes alone
    shapes = [tuple(b[0].shape) for b in t]
    assert shapes == ([(2, 5, 3), (2, 5, 3)]
                      + ([] if drop_last else [(1, 3, 3)]))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("superbatch", [1, 2])
def test_exact_resume_mid_epoch(shuffle, superbatch):
    def build(io):
        ds = io.TensorDataset(_arrays())
        sampler = (io.RandomSampler(ds, generator=9) if shuffle else None)
        kw = {"places": "cpu"} if io is tio else {}
        return io.DataLoader(ds, batch_size=3, sampler=sampler,
                             superbatch=superbatch, **kw)

    for io in (tio, jio):
        full = list(build(io))
        run = build(io)
        it = iter(run)
        head = [next(it), next(it)]
        state = run.state_dict()
        assert state["delivered"] == 2 * superbatch
        rest_same = list(it)
        fresh = build(io)
        fresh.set_state_dict(state)
        resumed = list(fresh)
        _assert_same(head + resumed, full)
        _assert_same(resumed, rest_same)
        if io is tio:
            port_resumed, port_state = resumed, state
        else:
            _assert_same(port_resumed, resumed)
            assert port_state == state
    # a snapshot taken after the epoch ended arms nothing
    done = build(tio)
    list(done)
    again = build(tio)
    again.set_state_dict(done.state_dict())
    assert len(list(again)) == len(list(build(tio)))


@pytest.mark.parametrize("name", ["InMemoryDataset",
                                  "MultiSlotInMemoryDataset"])
def test_in_memory_datasets_raise_citing_the_roadmap(name):
    """Ported since the sparse CTR slice (tests/test_torch_in_memory_
    dataset.py holds them against JAX's): both packages refuse a dataset
    without slots the same way."""
    assert hasattr(jio, name)
    from paddle_tpu.framework.errors import InvalidArgumentError as JErr

    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    with pytest.raises(JErr, match="at least one slot"):
        getattr(jio, name)(slots=[])
    with pytest.raises(InvalidArgumentError, match="at least one slot"):
        getattr(tio, name)(slots=[])
