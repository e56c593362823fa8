"""The 1.x long tail against the JAX package: ``nn.functional.extras``
(forward and ``jax.grad``), ``fluid.layers``' resize / pad / crop /
grid-sampling names, ``hash`` (bit for bit, keys above 2^63 too), the 1.x
beam-search ops, ``filter_by_instag`` and ``similarity_focus``; the random
ops (``sampling_id``, the ``*_batch_size_like`` draws, ``random_crop``,
``sampled_softmax_with_cross_entropy``) by their invariants, drawn from an
explicit seed: the port cannot reproduce ``jax.random``'s bits.

Float outputs within rtol / atol 1e-5, integer outputs equal in value,
gradients within 1e-4 of the JAX gradient's rms (``torch_op_pairs``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid.layers as jfl
import paddle_tpu_torch.fluid.layers as tfl
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.framework.errors import UnimplementedError
from paddle_tpu_torch.nn import functional as TF
from torch_op_pairs import (check_out, jax_references, np_,  # noqa: F401
                            on_the_cpu, torch_side)


def _r(seed, *shape, lo=None):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.abs(a) + lo if lo is not None else a


EXTRAS = {
    "add_position_encoding": (lambda F: lambda x: F.add_position_encoding(
        x, 0.5, 2.0), [(2, 5, 8)]),
    "affine_channel": (lambda F: lambda x, s, b: F.affine_channel(
        x, s, b, act="relu"), [(2, 3, 4, 4), (3,), (3,)]),
    "affine_channel_nhwc": (lambda F: lambda x, s, b: F.affine_channel(
        x, s, b, data_layout="NHWC"), [(2, 4, 4, 3), (3,), (3,)]),
    "rank_loss": (lambda F: lambda l, r: F.rank_loss(
        np.array([[1.0], [0.0], [0.5]], np.float32), l, r), [(3, 1), (3, 1)]),
    "margin_rank_loss": (lambda F: lambda l, r: F.margin_rank_loss(
        np.array([[1.0], [-1.0], [1.0]], np.float32), l, r, margin=0.2),
        [(3, 1), (3, 1)]),
    "shuffle_channel": (lambda F: lambda x: F.shuffle_channel(x, 2),
                        [(2, 6, 3, 3)]),
    "space_to_depth": (lambda F: lambda x: F.space_to_depth(x, 2),
                       [(2, 3, 4, 6)]),
    "fsp_matrix": (lambda F: lambda x, y: F.fsp_matrix(x, y),
                   [(2, 3, 4, 5), (2, 4, 4, 5)]),
    "lrn": (lambda F: lambda x: F.lrn(x, n=5, k=2.0, alpha=1e-3),
            [(2, 7, 3, 3)]),
    "im2sequence": (lambda F: lambda x: F.im2sequence(
        x, filter_size=2, stride=1), [(2, 3, 4, 5)]),
    "im2sequence_pad2": (lambda F: lambda x: F.im2sequence(
        x, filter_size=[2, 3], stride=[2, 1], padding=[1, 2]),
        [(1, 2, 5, 5)]),
    "im2sequence_pad4": (lambda F: lambda x: F.im2sequence(
        x, filter_size=3, stride=2, padding=[1, 0, 2, 1]), [(1, 2, 6, 5)]),
    "adaptive_pool2d_avg": (lambda F: lambda x: F.adaptive_pool2d(
        x, 3, "avg"), [(2, 3, 7, 6)]),
    "adaptive_pool2d_max": (lambda F: lambda x: F.adaptive_pool2d(
        x, [2, 3], "max"), [(2, 3, 7, 6)]),
    "adaptive_pool3d_avg": (lambda F: lambda x: F.adaptive_pool3d(
        x, 2, "avg"), [(1, 2, 5, 4, 6)]),
}


#: JAX's local_response_norm has no reverse-mode rule: forward only
NO_JAX_GRAD = {"lrn"}
_Y = np.array([[0], [3], [1], [1], [2]], np.int64)
EXTRAS.update({
    "bpr_loss": (lambda F: lambda x: F.bpr_loss(x, _Y), [(5, 4)]),
    "cvm": (lambda F: lambda x: F.continuous_value_model(
        abs(x), None, True), [(4, 5)]),
    "cvm_off": (lambda F: lambda x: F.continuous_value_model(
        x, None, False), [(4, 5)]),
})


def _extras_case(name):
    make, shapes = EXTRAS[name]
    arrays = [_r(i, *s) for i, s in enumerate(shapes)]
    grad = () if name in NO_JAX_GRAD else tuple(range(len(arrays)))
    return make, arrays, grad


@pytest.fixture(scope="module")
def extras_refs():
    """Every EXTRAS case's JAX output and gradients, from one compile."""
    cases = {}
    for name in EXTRAS:
        make, arrays, grad = _extras_case(name)
        cases[name] = (make(JF), arrays, grad, lambda o: o, 1)
    return jax_references(cases)


@pytest.mark.parametrize("name", sorted(EXTRAS))
def test_extras_op_matches_jax(name, extras_refs):
    make, arrays, grad = _extras_case(name)
    jout, jg = extras_refs[name]
    torch_side(make(TF), arrays, jout, jg, grad)


def test_fill_constant_batch_size_like_matches_jax():
    ref = np.zeros((3, 7), np.float32)
    check_out(TF.fill_constant_batch_size_like(ref, [1, 4], "float32", 2.5,
                                               output_dim_idx=0),
              JF.fill_constant_batch_size_like(ref, [1, 4], "float32", 2.5))
    check_out(TF.fill_constant_batch_size_like(ref, [2, 1], "int64", 3,
                                               input_dim_idx=1,
                                               output_dim_idx=1),
              JF.fill_constant_batch_size_like(ref, [2, 1], "int64", 3,
                                               input_dim_idx=1,
                                               output_dim_idx=1))


def test_random_extras_invariants():
    """Shapes, ranges and dtypes; one nonzero seed repeats its draw; a
    degenerate probability row picks its one index."""
    probs = np.zeros((6, 5), np.float32)
    probs[np.arange(6), [0, 4, 2, 2, 1, 3]] = 1.0
    ids = TF.sampling_id(probs, seed=7)
    assert ids.dtype == torch.int64
    assert ids.tolist() == [0, 4, 2, 2, 1, 3]
    flat = np.full((1000, 4), 0.25, np.float32)
    a, b = TF.sampling_id(flat, seed=3), TF.sampling_id(flat, seed=3)
    assert torch.equal(a, b) and set(a.tolist()) == {0, 1, 2, 3}
    ref = np.zeros((3, 7), np.float32)
    u = TF.uniform_random_batch_size_like(ref, [1, 200], min=-2.0, max=0.5,
                                          seed=3)
    g = TF.gaussian_random_batch_size_like(ref, [1, 2000], mean=1.0,
                                           std=0.5, seed=3)
    assert tuple(u.shape) == (3, 200) and tuple(g.shape) == (3, 2000)
    assert float(u.min()) >= -2.0 and float(u.max()) < 0.5
    assert abs(float(g.mean()) - 1.0) < 0.05
    assert abs(float(g.std()) - 0.5) < 0.05
    assert torch.equal(u, TF.uniform_random_batch_size_like(
        ref, [1, 200], min=-2.0, max=0.5, seed=3))
    d = TF.uniform_random_batch_size_like(ref, [1, 200], dtype="float64")
    assert d.dtype == torch.float64


# -- fluid.layers: resize, pad, crop, grid sampling ---------------------------
RESIZE = {
    "pad2d_constant": (lambda L: lambda x: L.pad2d(
        x, [1, 0, 2, 1], pad_value=0.5), (2, 3, 4, 5)),
    "pad2d_reflect": (lambda L: lambda x: L.pad2d(
        x, [1, 2, 2, 1], mode="reflect"), (2, 3, 4, 5)),
    "pad2d_edge_nhwc": (lambda L: lambda x: L.pad2d(
        x, [1, 1, 0, 2], mode="edge", data_format="NHWC"), (2, 4, 5, 3)),
    "image_resize_bilinear": (lambda L: lambda x: L.image_resize(
        x, out_shape=[6, 7]), (2, 3, 4, 5)),
    "image_resize_nearest": (lambda L: lambda x: L.image_resize(
        x, scale=2.0, resample="NEAREST"), (2, 3, 4, 5)),
    "resize_bilinear": (lambda L: lambda x: L.resize_bilinear(
        x, out_shape=[3, 9], align_corners=False, align_mode=0),
        (1, 2, 5, 5)),
    "resize_nearest": (lambda L: lambda x: L.resize_nearest(
        x, out_shape=[7, 3]), (1, 2, 5, 5)),
    "resize_linear": (lambda L: lambda x: L.resize_linear(
        x, out_shape=[9]), (2, 3, 5)),
    "resize_trilinear": (lambda L: lambda x: L.resize_trilinear(
        x, out_shape=[3, 4, 5]), (1, 2, 2, 3, 4)),
    "image_resize_short": (lambda L: lambda x: L.image_resize_short(x, 6),
                           (1, 2, 4, 7)),
    "crop_tensor": (lambda L: lambda x: L.crop_tensor(
        x, shape=[2, 2, 3], offsets=[0, 1, 1]), (2, 4, 5)),
}


_GRID = np.random.RandomState(1).uniform(-1.1, 1.1, (2, 4, 3, 2)).astype(
    np.float32)
RESIZE["grid_sampler"] = (lambda L: lambda x: L.grid_sampler(x, _GRID),
                          (2, 3, 5, 6))


@pytest.fixture(scope="module")
def resize_refs():
    return jax_references({n: (make(jfl), [_r(0, *shape)], (0,),
                               lambda o: o, 1)
                           for n, (make, shape) in RESIZE.items()})


@pytest.mark.parametrize("name", sorted(RESIZE))
def test_resize_pad_crop_names_match_jax(name, resize_refs):
    make, shape = RESIZE[name]
    jout, jg = resize_refs[name]
    torch_side(make(tfl), [_r(0, *shape)], jout, jg)


def test_random_crop_invariants():
    x = torch.arange(3 * 2 * 6 * 7, dtype=torch.float32).reshape(3, 2, 6, 7)
    a = tfl.random_crop(x, [4, 5], seed=11)
    assert tuple(a.shape) == (3, 2, 4, 5)
    assert torch.equal(a, tfl.random_crop(x, [4, 5], seed=11))
    starts = set()
    for i in range(3):
        for c in range(2):
            y0 = int(a[i, c, 0, 0] - x[i, c, 0, 0]) // 7
            x0 = int(a[i, c, 0, 0] - x[i, c, 0, 0]) % 7
            assert torch.equal(a[i, c], x[i, c, y0:y0 + 4, x0:x0 + 5])
            starts.add((i, c, y0, x0))
    single = tfl.random_crop(x[0, 0], [6, 3])
    assert tuple(single.shape) == (6, 3)
    assert torch.equal(single, x[0, 0, :, int(single[0, 0]) % 7:][:, :3])


# -- hash ----------------------------------------------------------------------
def test_hash_is_bit_equal_to_jax_above_2_63_too():
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 2 ** 62, (5, 3), dtype=np.int64).astype(np.uint64)
    keys[0, 0] = np.uint64(2 ** 64 - 1)
    keys[1, 2] = np.uint64(2 ** 63 + 12345)
    keys[2] = [0, 1, 2 ** 63]
    for size, num in ((1000, 1), (2 ** 40 + 7, 3)):
        want = np.asarray(jfl.hash(keys, size, num_hash=num))
        got = tfl.hash(keys, size, num_hash=num)
        np.testing.assert_array_equal(np_(got), want.astype(np.int64))
        # the same bits as int64 give the same ids
        bits = torch.from_numpy(keys.view(np.int64))
        np.testing.assert_array_equal(np_(tfl.hash(bits, size, num)), want)
    ids = rng.randint(0, 10 ** 6, (4, 1)).astype(np.int64)
    np.testing.assert_array_equal(np_(tfl.hash(ids, 5000)),
                                  np.asarray(jfl.hash(ids, 5000)))


def test_sampled_softmax_invariants_and_hit_shift():
    """Shape, positivity, one seed repeats; the loss equals the sampled
    estimator recomputed from the same seeded draw, an accidental hit of
    a true class moved to ``(id + 1) % classes``."""
    rng = np.random.RandomState(0)
    B, C, S, nt = 6, 5, 8, 2
    logits = torch.from_numpy(rng.randn(B, C).astype(np.float32))
    label = torch.from_numpy(np.array([[0, 1], [2, 3], [4, 0], [1, 2],
                                       [3, 4], [0, 2]], np.int64))
    out = tfl.sampled_softmax_with_cross_entropy(logits, label, S,
                                                 num_true=nt, seed=5)
    assert tuple(out.shape) == (B, nt) and bool((out > 0).all())
    assert torch.equal(out, tfl.sampled_softmax_with_cross_entropy(
        logits, label, S, num_true=nt, seed=5))
    neg = torch.randint(0, C, (B, S),
                        generator=torch.Generator().manual_seed(5))
    hit = (neg[..., None] == label[:, None, :]).any(-1)
    assert bool(hit.any())
    neg = torch.where(hit, (neg + 1) % C, neg)
    picked = torch.gather(logits, 1, torch.cat([label, neg], 1))
    want = torch.logsumexp(picked, 1, keepdim=True) - picked[:, :nt]
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)


# -- the 1.x beam-search ops ---------------------------------------------------
@pytest.mark.parametrize("accumulated", [True, False])
def test_beam_search_matches_jax(accumulated):
    rng = np.random.RandomState(0)
    batch, W, K, end = 3, 4, 4, 9
    pre_ids = rng.randint(0, 8, (batch * W, 1)).astype(np.int64)
    pre_ids[[1, 6]] = end  # finished beams
    pre_scores = rng.randn(batch * W, 1).astype(np.float32)
    ids = rng.randint(0, 8, (batch * W, K)).astype(np.int64)
    scores = (rng.rand(batch * W, K).astype(np.float32) if not accumulated
              else rng.randn(batch * W, K).astype(np.float32))
    scores[4:8] = scores[4]  # ties across beams and positions
    kw = dict(is_accumulated=accumulated, return_parent_idx=True)
    got = tfl.beam_search(pre_ids, pre_scores, torch.from_numpy(ids),
                          torch.from_numpy(scores), W, end, **kw)
    want = jax.jit(lambda *a: jfl.beam_search(*a, W, end, **kw))(
        pre_ids, pre_scores, ids, scores)
    check_out(got, want)
    sel = np_(got[0]).reshape(-1)
    assert (sel[np_(got[2]) == 1] == end).all()  # a finished beam re-emits


def test_beam_search_decode_matches_jax():
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 7, (5, 2, 3)).astype(np.int64)
    parents = rng.randint(0, 3, (5, 2, 3)).astype(np.int64)
    check_out(tfl.beam_search_decode(torch.from_numpy(ids),
                                     torch.from_numpy(parents)),
              jfl.beam_search_decode(ids, parents))
    with pytest.raises(UnimplementedError):
        tfl.beam_search_decode(torch.from_numpy(ids),
                               torch.zeros(5, 2, 3))


def test_filter_by_instag_matches_jax():
    ins = _r(0, 5, 3)
    tags = np.array([[1, -1], [2, 3], [4, -1], [3, 1], [5, 5]], np.int64)
    for want_tags in ([1, 5], [7]):
        check_out(tfl.filter_by_instag(ins, tags, np.array(want_tags)),
                  jfl.filter_by_instag(ins, tags, np.array(want_tags)))
    one = np.array([1, 2, 1, 4, 1], np.int64)
    check_out(tfl.filter_by_instag(ins, one, np.array([9]), False, 3.0),
              jfl.filter_by_instag(ins, one, np.array([9]), False, 3.0))


@pytest.mark.parametrize("axis,indexes", [(1, [0]), (1, [0, 2]), (2, [1]),
                                          (3, [0, 3])])
def test_similarity_focus_matches_jax(axis, indexes):
    x = np.random.RandomState(axis).rand(2, 3, 4, 5).astype(np.float32)
    x[0, :, 1, 2] = x[0, :, 1, 1]  # ties: the first maximum wins
    check_out(tfl.similarity_focus(x, axis, indexes),
              jax.jit(jfl.similarity_focus, static_argnums=(1, 2))(
                  jnp.asarray(x), axis, tuple(indexes)))


def test_similarity_focus_reference_docstring_example():
    x = np.array([[[[0.8, 0.1], [0.4, 0.5]], [[0.9, 0.7], [0.9, 0.9]],
                   [[0.8, 0.9], [0.1, 0.2]]],
                  [[[0.2, 0.5], [0.3, 0.4]], [[0.9, 0.7], [0.8, 0.4]],
                   [[0.0, 0.2], [0.4, 0.7]]]], np.float32)
    out = np_(tfl.similarity_focus(x, axis=1, indexes=[0]))
    for c in range(3):
        np.testing.assert_array_equal(out[0, c], [[1, 0], [0, 1]])
        np.testing.assert_array_equal(out[1, c], [[0, 1], [1, 0]])
