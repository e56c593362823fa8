"""fleet's host modules in the port against the JAX package's:
``fleet.metrics`` (a 2-rank gloo world against JAX's one-process
functions on the ranks' values joined — the same global reduction),
``fleet.utils`` (``LocalFS``, ``HDFSClient``, ``KVServer`` on an
ephemeral local port with a timeout on every request),
``fleet.data_generator`` (the MultiSlot text of both packages' generators
on the same lines, byte for byte) and ``distributed.mean_trees`` (bit for
bit).  Metrics at rtol 1e-12 (float64 on both sides).
"""
import io
import os
import urllib.request

import numpy as np
import pytest

from paddle_tpu.distributed import gang as jgang
from paddle_tpu.distributed.fleet import data_generator as jdg
from paddle_tpu.distributed.fleet import metrics as jfm
from paddle_tpu.distributed.fleet import utils as jutils
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.fleet import data_generator as tdg
from paddle_tpu_torch.distributed.fleet import utils as tutils
from paddle_tpu_torch.framework.errors import UnimplementedError

import torch_dist_workers as W


def _values():
    rng = np.random.RandomState(4)
    return {"a": rng.randn(2, 5),
            "pos": rng.randint(0, 9, (2, 16)).astype(np.float64),
            "neg": rng.randint(0, 9, (2, 16)).astype(np.float64),
            "abserr": rng.rand(2, 3), "sqrerr": rng.rand(2, 3),
            "correct": rng.randint(0, 5, (2, 3)).astype(np.float64),
            "n": np.full((2, 3), 5.0)}


@pytest.fixture(scope="module")
def values():
    return _values()


@pytest.fixture(scope="module")
def world(values):
    return spawn(W.metrics_world, (values,), nprocs=2, backend="gloo",
                 timeout=120).results


def test_metrics_reduce_over_the_world_as_jax(world, values):
    v = values
    want = {"sum": jfm.sum(v["a"].sum(0)), "max": v["a"].max(0),
            "min": v["a"].min(0),
            "auc": jfm.auc(v["pos"].sum(0), v["neg"].sum(0)),
            "mae": jfm.mae(v["abserr"].sum(0), v["n"].sum(0)),
            "mse": jfm.mse(v["sqrerr"].sum(0), v["n"].sum(0)),
            "rmse": jfm.rmse(v["sqrerr"].sum(0), v["n"].sum(0)),
            "acc": jfm.acc(v["correct"].sum(0), v["n"].sum(0))}
    for r in range(2):
        for k, w in want.items():
            got = world[r][k]
            assert not (isinstance(got, dict) and "error" in got), got
            np.testing.assert_allclose(got, w, rtol=1e-12, err_msg=k)


def test_metrics_in_one_process_are_jax_s(values):
    a = values["a"][0]
    for name in ("sum", "max", "min"):
        np.testing.assert_array_equal(getattr(tfleet.metrics, name)(a),
                                      getattr(jfm, name)(a))
    assert tfleet.metrics.auc(values["pos"][0], values["neg"][0]) == \
        jfm.auc(values["pos"][0], values["neg"][0])
    assert tfleet.metrics.auc(np.zeros(4), np.ones(4)) == 0.5


def _fs_ops(fs, root):
    out = []
    d = os.path.join(root, "a", "b")
    fs.mkdirs(d)
    out.append((fs.is_dir(d), fs.is_exist(d)))
    f = os.path.join(d, "x.txt")
    fs.touch(f)
    fs.touch(f, exist_ok=True)
    try:
        fs.touch(f, exist_ok=False)
    except FileExistsError:
        out.append("exists")
    out.append(fs.is_file(f))
    out.append(fs.ls_dir(d))
    fs.mv(f, os.path.join(d, "y.txt"), overwrite=True)
    out.append(fs.is_file(os.path.join(d, "y.txt")))
    out.append(fs.list_dirs(os.path.join(root, "a")))
    fs.delete(d)
    out.append((fs.is_exist(d), fs.need_upload_download()))
    return out


def test_local_fs_and_hdfs_client_as_jax(tmp_path):
    assert _fs_ops(tfleet.LocalFS(), str(tmp_path / "t")) == \
        _fs_ops(jutils.LocalFS(), str(tmp_path / "j"))
    client = tfleet.HDFSClient()
    assert client.need_upload_download()
    with pytest.raises(UnimplementedError, match="hadoop"):
        client.ls_dir("/x")


@pytest.mark.parametrize("pkg", [tutils, jutils], ids=["port", "jax"])
def test_kv_server_put_get_delete(pkg):
    server = pkg.KVServer(0, size={"rank": 1})  # an ephemeral port
    port = server.http_server.server_address[1]
    server.start()
    try:
        base = f"http://127.0.0.1:{port}"
        req = urllib.request.Request(f"{base}/rank/0", data=b"host:123",
                                     method="PUT")
        assert urllib.request.urlopen(req, timeout=10).status == 200
        assert urllib.request.urlopen(f"{base}/rank/0",
                                      timeout=10).read() == b"host:123"
        with pytest.raises(Exception):
            urllib.request.urlopen(f"{base}/rank/9", timeout=10)
        assert not server.should_stop()
        urllib.request.urlopen(urllib.request.Request(
            f"{base}/rank/0", method="DELETE"), timeout=10)
        assert server.http_server.get_deleted_size() == 1
        assert server.should_stop()
    finally:
        server.stop()


def _generators(dg):
    class Words(dg.MultiSlotDataGenerator):
        def generate_sample(self, line):
            def it():
                f = [int(x) for x in line.split()]
                yield [("words", f[:-1]), ("label", [f[-1]])]
            return it

    class Strings(dg.MultiSlotStringDataGenerator):
        def generate_sample(self, line):
            def it():
                yield [("w", line.split())]
            return it

    class Bad(dg.MultiSlotDataGenerator):
        def generate_sample(self, line):
            def it():
                yield [("a", [1]), ("b", [2])] if line == "x\n" else \
                    [("b", [2]), ("a", [1])]
            return it

    return Words, Strings, Bad


@pytest.mark.parametrize("batch", [1, 2])
def test_data_generators_write_jax_s_text(batch):
    lines = ["1926 8 17 1\n", "3 4 5 0\n", "7 9 1\n"]
    outs = []
    for dg in (tdg, jdg):
        Words, Strings, Bad = _generators(dg)
        text = []
        for cls in (Words, Strings):
            gen = cls()
            gen.set_batch(batch)
            out = io.StringIO()
            gen.run_from_stdin(source=list(lines), out=out)
            text.append(out.getvalue())
        with pytest.raises(Exception) as e:
            Bad().run_from_stdin(source=["x\n", "y\n"], out=io.StringIO())
        text.append(type(e.value).__name__)
        with pytest.raises(NotImplementedError):
            dg.DataGenerator().run_from_memory(out=io.StringIO())
        outs.append(text)
    assert outs[0] == outs[1]
    assert outs[0][2] == "InvalidArgumentError"
    assert outs[0][0].splitlines()[0] == "3 1926 8 17 1 1"


def test_mean_trees_bit_equal_to_jax():
    rng = np.random.RandomState(1)
    trees = [{"w": rng.randn(3, 4).astype(np.float32),
              "b": [rng.randn(4), np.float32(r)]} for r in range(3)]
    got = tdist.mean_trees(trees)
    want = jgang.mean_trees(trees)
    np.testing.assert_array_equal(got["w"], np.asarray(want["w"]))
    for g, w in zip(got["b"], want["b"]):
        np.testing.assert_array_equal(g, np.asarray(w))
        assert np.asarray(g).dtype == np.float32


def test_fleet_names_are_bound():
    for name in ("LocalFS", "HDFSClient", "metrics", "utils",
                 "data_generator"):
        assert hasattr(tfleet, name), name
