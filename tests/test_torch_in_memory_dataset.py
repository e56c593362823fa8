"""The port's native ingest (``paddle_tpu_torch/native``, its copy of the C++
engine, and ``paddle_tpu_torch/io/in_memory_dataset.py``) held against the
JAX package's on the same seeded text files.

Both packages build their own copy of the engine with ``g++``; the same
files, thread count and ``global_shuffle`` seed must give bit-equal
batches, and the same malformed inputs the same error classes and
messages.  The CTR case feeds ``wide_deep_tiny(sparse=True)`` from the
ingest in both packages (losses at rtol 1e-5).
"""
import os

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import io as jio
from paddle_tpu.framework import errors as jerr
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import native as tnative
from paddle_tpu_torch.framework import errors as terr

SLOTS = [("feat", 5, "float32"), ("label", 1, "int64")]
MULTI = [("ids", "int64", 4), ("dense", "float32", 3), ("label", "int64", 1)]


def _write_parts(tmp_path, n_files=4, rows_per_file=25, ncols=6, seed=0):
    rng = np.random.RandomState(seed)
    files = []
    for i in range(n_files):
        rows = np.round(rng.randn(rows_per_file, ncols) * 100, 3)
        rows[:, -1] = rng.randint(0, 2, rows_per_file)
        p = os.path.join(tmp_path, f"part-{i}.txt")
        sep = "," if i % 2 else " "  # both separators are valid
        with open(p, "w") as f:
            for r in rows:
                f.write(sep.join(repr(float(v)) for v in r) + "\n")
        files.append(p)
    return files


def _both(files, threads, seed=None, slots=SLOTS):
    out = []
    for io in (jio, tio):
        ds = io.InMemoryDataset(slots=slots)
        ds.set_filelist(files)
        assert ds.load_into_memory(thread_num=threads) == len(ds)
        if seed is not None:
            ds.global_shuffle(seed=seed)
        out.append(ds)
    return out


def _assert_same_batches(jds, tds, bs, **kw):
    jb, tb = list(jds.batch_iter(bs, **kw)), list(tds.batch_iter(bs, **kw))
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, tuple):
                for xx, yy in zip(x, y):
                    np.testing.assert_array_equal(yy, xx)
            else:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("threads,seed,bs", [(1, None, 100), (3, 7, 32),
                                             (4, 0, 10), (8, 2 ** 63 + 5, 7)])
def test_same_files_same_batches_as_jax(tmp_path, threads, seed, bs):
    files = _write_parts(tmp_path)
    jds, tds = _both(files, threads, seed)
    _assert_same_batches(jds, tds, bs)
    _assert_same_batches(jds, tds, bs, drop_last=True)


def test_shuffle_is_a_seeded_permutation(tmp_path):
    files = _write_parts(tmp_path)
    _, ds = _both(files, 2)
    before = next(iter(ds.batch_iter(100)))[0].copy()
    ds.global_shuffle(seed=7)
    s1 = next(iter(ds.batch_iter(100)))[0].copy()
    ds.local_shuffle(seed=7)
    s2 = next(iter(ds.batch_iter(100)))[0].copy()
    np.testing.assert_array_equal(s1, s2)
    assert not np.array_equal(s1, before)
    np.testing.assert_array_equal(np.sort(s1, 0), np.sort(before, 0))


def test_batches_restart_and_iterators_are_independent(tmp_path):
    files = _write_parts(tmp_path)
    _, ds = _both(files, 2)
    assert [t[0].shape[0] for t in ds.batch_iter(32)] == [32, 32, 32, 4]
    assert sum(1 for _ in ds.batch_iter(10)) == 10
    it1, it2 = ds.batch_iter(10), ds.batch_iter(10)
    a1, b1, a2 = next(it1)[0], next(it2)[0], next(it1)[0]
    np.testing.assert_array_equal(a1, b1)
    assert not np.array_equal(a1, a2)
    assert sum(1 for _ in it1) == 8
    with pytest.raises(terr.InvalidArgumentError, match="batch_size"):
        ds.batch_iter(0)
    with pytest.raises(terr.InvalidArgumentError, match="batch_iter"):
        iter(ds)


def test_incremental_load_and_release(tmp_path):
    files = _write_parts(tmp_path)
    ds = tio.InMemoryDataset(slots=SLOTS)
    with pytest.raises(terr.InvalidArgumentError, match="set_filelist"):
        ds.load_into_memory()
    ds.set_filelist(files[:2])
    assert ds.load_into_memory() == 50  # FLAGS_paddle_num_threads: 1
    ds.set_filelist(files[2:])
    assert ds.load_into_memory() == 50 and len(ds) == 100
    ds.release_memory()
    assert ds.get_memory_data_size() == 0


def _errors(files, make):
    out = []
    for io, err in ((jio, jerr), (tio, terr)):
        ds = make(io)
        ds.set_filelist(files)
        with pytest.raises(Exception) as info:
            ds.load_into_memory()
        out.append((type(info.value).__name__, str(info.value)))
    return out


@pytest.mark.parametrize("content,expect", [
    (None, ("NotFoundError", "cannot open")),
    ("1 2 3 4 5 6\n1 2 3\n", ("InvalidArgumentError", "bad.txt:2")),
    ("1 2 three 4 5 6\n", ("InvalidArgumentError", "unparsable"))])
def test_load_errors_map_to_the_same_classes(tmp_path, content, expect):
    p = os.path.join(tmp_path, "bad.txt")
    if content is not None:
        with open(p, "w") as f:
            f.write(content)
    (jname, jmsg), (tname, tmsg) = _errors(
        [p], lambda io: io.InMemoryDataset(slots=SLOTS))
    assert jname == tname == expect[0]
    assert tmsg == jmsg and expect[1] in tmsg
    with pytest.raises(getattr(terr, expect[0])):
        ds = tio.InMemoryDataset(slots=SLOTS)
        ds.set_filelist([p])
        ds.load_into_memory()


@pytest.mark.parametrize("line,expect", [
    ("9 1 2 3 4 5 6 7 8 9 3 0 0 0 1 0", "outside"),
    ("1 18446744073709551617 3 0 0 0 1 0", "unparsable"),
    ("2 1 x 3 0 0 0 1 0", "unparsable")])
def test_multislot_errors_match_jax(tmp_path, line, expect):
    p = tmp_path / "part.txt"
    p.write_text(line + "\n")
    (jname, jmsg), (tname, tmsg) = _errors(
        [str(p)], lambda io: io.MultiSlotInMemoryDataset(slots=MULTI))
    assert jname == tname and tmsg == jmsg and expect in tmsg


def test_constructor_errors_match_jax():
    for bad in ([], [("x", 0, "float32")]):
        for io, err in ((jio, jerr), (tio, terr)):
            with pytest.raises(err.InvalidArgumentError):
                io.InMemoryDataset(slots=bad)
    for bad in ([], [("x", "float64", 1)], [("x", "int64", 0)]):
        for io, err in ((jio, jerr), (tio, terr)):
            with pytest.raises(err.InvalidArgumentError):
                io.MultiSlotInMemoryDataset(slots=bad)


def test_multislot_same_batches_as_jax(tmp_path):
    rng = np.random.RandomState(0)
    files = []
    for k in range(4):
        lines = []
        for i in range(30):
            n = rng.randint(0, 5)
            ids = " ".join(str(v) for v in rng.randint(0, 2 ** 40, n))
            dense = " ".join(f"{v:.5f}" for v in rng.randn(3))
            lines.append(f"{n} {ids} 3 {dense} 1 {i % 2}".replace("  ", " "))
        p = tmp_path / f"ms-{k}.txt"
        p.write_text("\n".join(lines) + "\n")
        files.append(str(p))
    dss = []
    for io in (jio, tio):
        ds = io.MultiSlotInMemoryDataset(slots=MULTI)
        ds.set_filelist(files)
        assert ds.load_into_memory(thread_num=3) == 120
        ds.global_shuffle(seed=11)
        dss.append(ds)
    _assert_same_batches(*dss, 16, return_lens=True)
    _assert_same_batches(*dss, 50, drop_last=True)
    big = 2 ** 62 + 12345  # exact at full int64 width
    p = tmp_path / "big.txt"
    p.write_text(f"1 {big} 3 0 0 0 1 7\n")
    ds = tio.MultiSlotInMemoryDataset(slots=MULTI)
    ds.set_filelist([str(p)])
    ds.load_into_memory()
    assert int(next(iter(ds.batch_iter(1)))[0][0, 0]) == big


def test_unterminated_final_line_buffer_multiple(tmp_path):
    p = os.path.join(tmp_path, "edge.txt")
    first = " ".join(["1.0"] * 6) + "\n"
    base = " ".join(["2.0"] * 5) + " "
    last = base + "3." + "0" * (2 * 65535 - len(base) - 2)
    with open(p, "w") as f:
        f.write(first + last)  # no trailing newline
    ds = tio.InMemoryDataset(slots=SLOTS)
    ds.set_filelist([p])
    assert ds.load_into_memory() == 2


def test_ctr_training_from_native_ingest_matches_jax(tmp_path):
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.models import wide_deep as jwd
    from paddle_tpu_torch.bridge import load_jax_params
    from paddle_tpu_torch.models import wide_deep_tiny

    rng = np.random.RandomState(0)
    files = []
    for i in range(2):
        p = os.path.join(tmp_path, f"ctr-{i}.txt")
        with open(p, "w") as f:
            for _ in range(128):
                ids = rng.randint(0, 64, size=4)
                dense = np.round(rng.randn(4), 4)
                f.write(" ".join(map(str, list(ids) + list(dense)
                                     + [int(ids[0] < 32)])) + "\n")
        files.append(p)
    slots = [("sparse", 4, "int64"), ("dense", 4, "float32"),
             ("label", 1, "float32")]
    jds, tds = _both(files, 2, seed=1, slots=slots)
    jpt.seed(0)
    jnet = jwd.wide_deep_tiny(sparse=True)
    tnet = wide_deep_tiny(sparse=True, device="cpu")
    load_jax_params(tnet, {k: np.asarray(p.value)
                           for k, p in jnet.named_parameters()})
    jm = jpt.Model(jnet, inputs=["sparse", "dense"], labels=["label"])
    jm.prepare(optimizer=jopt.Adam(1e-2, lazy_mode=True), loss=jnet.loss)
    tm = tpt.Model(tnet, inputs=["sparse", "dense"], labels=["label"])
    tm.prepare(optimizer=tpt.optimizer.Adam(1e-2, lazy_mode=True),
               loss=tnet.loss)
    losses = []
    for _ in range(8):
        for (js, jd, jl), (ts, td, tl) in zip(jds.batch_iter(64),
                                              tds.batch_iter(64)):
            a = float(np.asarray(jm.train_batch([js, jd], [jl])[0]))
            b = tm.train_batch([ts, td], [tl])[0]
            np.testing.assert_allclose(b, a, rtol=1e-5)
            losses.append(b)
    assert losses[-1] < losses[0] * 0.7, losses


# -- the build -----------------------------------------------------------------
def test_native_library_builds_inside_the_package(tmp_path):
    lib = tnative.ingest_lib()
    path = tnative.library_path()
    assert path.exists() and path.parent == tnative.OUT
    assert path.parent.parent.name == "native"
    assert tnative.ingest_lib() is lib  # loaded once
    assert "-std=c++17" in tnative.CXX_FLAGS


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "ingest.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "OUT", tmp_path / "_build")
    with pytest.raises(tnative.NativeBuildError, match="native build failed"):
        tnative._build()
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on PATH
    with pytest.raises(tnative.NativeBuildError, match="g\\+\\+"):
        tnative._build()
    assert issubclass(tnative.NativeBuildError, terr.UnavailableError)
