"""paddle_tpu_torch.serving's bucketing and InferenceEngine held against
paddle_tpu.serving's.

Ports tests/test_serving.py::TestBucketing and ::TestInferenceEngine: the
routing and padding of both packages agree case for case; the engine's
executable set is closed (``warmup() == compile_count == len(buckets)``
after mixed traffic), its answers equal the direct Predictor's (and the
JAX engine's on the same weights) on the unpadded rows, a bucket miss is
rejected or served unbatched, and ``swap_weights`` works between batches
and rejects a mismatched state.  The JAX engine's metrics on its event
bus (``test_metrics_published_on_bus``, ``test_s601_bucket_miss_churn``)
have no counterpart until the control-plane slice: the port's engine
keeps its metrics in ``stats()``.
"""
import os
import tempfile
import unittest

import numpy as np
import torch

import paddle_tpu as jpt
from paddle_tpu import nn as jnn
from paddle_tpu import serving as jserving

import paddle_tpu_torch as tpt
from paddle_tpu_torch import nn
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.serving import (Bucket, BucketSet, InferenceEngine,
                                      as_bucket)
from paddle_tpu_torch.static import InputSpec


class TestBucketing(unittest.TestCase):
    def test_as_bucket_shorthand(self):
        self.assertEqual(as_bucket((64,)).shapes, ((64,),))
        self.assertEqual(as_bucket(((64, 8), (64,))).shapes, ((64, 8), (64,)))
        b = Bucket(((16,),), batch_size=32)
        self.assertIs(as_bucket(b), b)
        with self.assertRaises(InvalidArgumentError):
            as_bucket("nope")
        with self.assertRaises(InvalidArgumentError):
            Bucket(((0,),))

    def test_route_smallest_fit(self):
        specs = [(64,), (16,), (256,)]
        bs, jbs = BucketSet(specs), jserving.BucketSet(specs)
        for shapes, want in ((((10,),), 1), (((16,),), 1), (((17,),), 0),
                             (((200,),), 2), (((300,),), -1),
                             (((10, 2),), -1)):
            self.assertEqual(bs.route(shapes), want)
            self.assertEqual(jbs.route(shapes), want)

    def test_pad_request(self):
        bs = BucketSet([((8, 4),)], pad_value=7)
        jbs = jserving.BucketSet([((8, 4),)], pad_value=7)
        x = np.ones((3, 4), np.float32)
        out = bs.pad_request(0, [x])
        self.assertEqual(out[0].shape, (8, 4))
        np.testing.assert_array_equal(out[0][:3], 1.0)
        np.testing.assert_array_equal(out[0][3:], 7.0)
        np.testing.assert_array_equal(out[0], jbs.pad_request(0, [x])[0])


class _TinyNet(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(8, 4)

    def forward(self, x):
        return self.fc(x)


def _export_tiny(tmpdir, name="m", seed=None, spec=(None, None, 8)):
    if seed is not None:
        tpt.seed(seed)
    net = _TinyNet()
    prefix = os.path.join(tmpdir, name)
    tpt.inference.save_inference_model(
        prefix, net, [InputSpec(list(spec), "float32")])
    return prefix, net


def _np(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x)).numpy()


class TestInferenceEngine(unittest.TestCase):
    @classmethod
    def setUpClass(cls):
        cls.tmp = tempfile.TemporaryDirectory()
        cls.prefix, cls.net = _export_tiny(cls.tmp.name, seed=1234)

    @classmethod
    def tearDownClass(cls):
        cls.tmp.cleanup()

    def _engine(self, **kw):
        kw.setdefault("max_batch_size", 4)
        kw.setdefault("max_queue_delay_ms", 2.0)
        kw.setdefault("device", "cpu")
        return InferenceEngine(
            self.prefix, [Bucket(((4, 8),)), Bucket(((16, 8),))], **kw)

    def test_closed_compile_set_under_mixed_traffic(self):
        with self._engine() as eng:
            self.assertEqual(eng.warmup(), 2)  # one executable per bucket
            rng = np.random.RandomState(0)
            futs = [eng.submit([rng.randn(n, 8).astype("float32")])
                    for n in (1, 3, 4, 2, 9, 16, 3, 11)]
            for f in futs:
                f.result(60)
            # mixed request shapes never built a third executable
            self.assertEqual(eng.compile_count, 2)
            st = eng.stats()
            self.assertEqual(st["completed"], 8)
            self.assertEqual(st["bucket_misses"], 0)
            self.assertEqual(st["compile_count"], 2)
            self.assertEqual(st["buckets"], 2)

    def test_outputs_match_direct_predictor_and_unpad(self):
        with self._engine() as eng:
            x = np.random.RandomState(1).randn(3, 8).astype("float32")
            got = eng.infer([x], timeout=60)[0]
            want = _np(self.net, x[None])[0]
            self.assertEqual(got.shape, (3, 4))  # padding sliced back off
            np.testing.assert_allclose(got, want, atol=1e-5)
            direct = eng._pred.run([x[None]])[0][0]
            np.testing.assert_allclose(got, direct, rtol=1e-6, atol=1e-6)

    def test_outputs_match_the_jax_engine(self):
        """The same weights behind both packages' engines."""
        jpt.seed(1234)
        jnet = jnn.Sequential(jnn.Linear(8, 4))
        tnet = nn.Sequential(nn.Linear(8, 4))
        load_jax_params(tnet, {k: np.asarray(p.value)
                               for k, p in jnet.named_parameters()})
        with tempfile.TemporaryDirectory() as td:
            jpre, tpre = os.path.join(td, "j"), os.path.join(td, "t")
            jpt.inference.save_inference_model(
                jpre, jnet, [jpt.static.InputSpec([None, None, 8],
                                                  "float32")],
                platforms=("cpu",))
            tpt.inference.save_inference_model(
                tpre, tnet, [InputSpec([None, None, 8], "float32")])
            buckets = [((4, 8),), ((16, 8),)]
            x = np.random.RandomState(2).randn(9, 8).astype("float32")
            with jserving.InferenceEngine(jpre, buckets,
                                          max_batch_size=4) as je, \
                    InferenceEngine(tpre, buckets, max_batch_size=4,
                                    device="cpu") as te:
                want = np.asarray(je.infer([x], timeout=60)[0])
                got = te.infer([x], timeout=60)[0]
        self.assertEqual(got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_bucket_miss_rejected_or_fallback(self):
        with self._engine() as eng:
            with self.assertRaises(InvalidArgumentError):
                eng.infer([np.zeros((20, 8), np.float32)], timeout=60)
            self.assertEqual(eng.stats()["bucket_misses"], 1)
        with self._engine(allow_bucket_fallback=True) as eng:
            x = np.random.RandomState(3).randn(20, 8).astype("float32")
            got = eng.infer([x], timeout=60)[0]
            np.testing.assert_allclose(got, _np(self.net, x[None])[0],
                                       atol=1e-5)
            st = eng.stats()
            self.assertEqual(st["bucket_misses"], 1)
            self.assertEqual(st["fallback_runs"], 1)
            self.assertEqual(eng.compile_count, 0)

    def test_hot_weight_swap_zero_recompiles(self):
        prefix2, net2 = _export_tiny(self.tmp.name, "m2", seed=5678)
        with self._engine() as eng:
            eng.warmup()
            x = np.random.RandomState(4).randn(3, 8).astype("float32")
            before = eng.infer([x], timeout=60)[0]
            eng.swap_weights(prefix2 + ".pdiparams")
            after = eng.infer([x], timeout=60)[0]
            self.assertEqual(eng.compile_count, 2)  # swap built nothing
            self.assertEqual(eng.stats()["weight_swaps"], 1)
            np.testing.assert_allclose(after, _np(net2, x[None])[0],
                                       atol=1e-5)
            self.assertFalse(np.allclose(after, before, atol=1e-5))

    def test_swap_rejects_mismatched_state(self):
        bad = os.path.join(self.tmp.name, "bad.pdiparams")
        other = nn.Linear(3, 3)
        tpt.save({"params": dict(other.named_parameters()),
                  "buffers": {}}, bad)
        with self._engine() as eng:
            with self.assertRaises(InvalidArgumentError):
                eng.swap_weights(bad)
            self.assertEqual(eng.stats()["weight_swaps"], 0)

    def test_synthetic_inputs_and_from_tuned(self):
        cfg = {"buckets": [((4, 8),), ((16, 8),)], "batch_size": 2,
               "max_queue_delay_ms": 1.0}
        with InferenceEngine.from_tuned(self.prefix, cfg,
                                        device="cpu") as eng:
            self.assertEqual(eng._max_batch, 2)
            probe = eng.synthetic_inputs(1)
            self.assertEqual([p.shape for p in probe], [(16, 8)])
            self.assertEqual(probe[0].dtype, np.float32)
            out = eng.infer(probe, timeout=60)[0]
            np.testing.assert_allclose(out, _np(self.net, probe[0][None])[0],
                                       atol=1e-5)
            self.assertEqual(eng.warmup(), 2)

    def test_closed_engine_refuses_requests(self):
        eng = self._engine()
        eng.close()
        with self.assertRaises(Exception):
            eng.submit([np.zeros((2, 8), np.float32)])


class TestRowBuckets(unittest.TestCase):
    """Buckets of the input's own rank: a request carries its rows (the
    card smoke's BERT form, ``Bucket(((16, 128),))`` over ``[None,
    128]``), is padded to the bucket's rows and answered with its own."""

    @classmethod
    def setUpClass(cls):
        cls.tmp = tempfile.TemporaryDirectory()
        cls.prefix, cls.net = _export_tiny(cls.tmp.name, seed=7,
                                           spec=(None, 8))

    @classmethod
    def tearDownClass(cls):
        cls.tmp.cleanup()

    def test_rows_routed_padded_and_answered(self):
        with InferenceEngine(self.prefix, [Bucket(((4, 8),)),
                                           Bucket(((16, 8),))],
                             max_batch_size=16, device="cpu") as eng:
            self.assertEqual(eng.warmup(), 2)
            rng = np.random.RandomState(5)
            xs = [rng.randn(n, 8).astype("float32")
                  for n in (1, 4, 5, 16, 2, 11)]
            outs = [f.result(60) for f in [eng.submit([x]) for x in xs]]
            self.assertEqual(eng.compile_count, 2)
            for x, (o,) in zip(xs, outs):
                self.assertEqual(o.shape, (len(x), 4))
                np.testing.assert_allclose(o, eng._pred.run([x])[0],
                                           rtol=1e-6, atol=1e-6)
            with self.assertRaises(InvalidArgumentError):
                eng.infer([np.zeros((17, 8), np.float32)], timeout=60)

    def test_bucket_of_no_matching_rank_refused(self):
        with self.assertRaises(InvalidArgumentError):
            InferenceEngine(self.prefix, [Bucket(((2, 4, 8),))],
                            device="cpu")
