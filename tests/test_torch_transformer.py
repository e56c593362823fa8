"""The port's ``nn.transformer`` held against the JAX package's on the
CPU: ``MultiHeadAttention`` (no mask, bool and float masks, other key /
value widths, the decode cache), post-LN and pre-LN encoder and decoder
layers, the stacks and the full ``Transformer`` at d_model 32, 4 heads,
2 + 2 layers; forward and the gradients of every parameter and of the
first input at rtol / atol 2e-5 (float32, dropout off: eval mode).

Also: ``state_dict`` names equal to the JAX names; the deep-copied layers
of a stack start equal and the copies draw nothing; the square mask is
bool; the MHA flash route (the plain flash version on the CPU, forced
through ``flash_eligible``) against the JAX MHA's dense route; the
cached decoder (the port's extension: the JAX decoder layer ignores its
``cache``) against the uncached causal forward of both packages; the amp
O1 dtypes (MHA's projections bf16, the LayerNorms float32).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tpt
import paddle_tpu_torch.nn as tnn
from paddle_tpu.amp import auto_cast as jauto_cast
from paddle_tpu_torch.amp import auto_cast as tauto_cast
from torch_nn_pairs import bridged, check_pair

TOL = dict(rtol=2e-5, atol=2e-5)
D, H, FF = 32, 4, 48
B, S, T = 2, 6, 5

_attn = importlib.import_module("paddle_tpu_torch.nn.functional.attention")


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(name, *args, **kw):
    jpt.seed(7)
    jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(tnn, name)(*args, **kw)
    jl.eval()
    return jl, bridged(jl, tl)


def _padding_mask(lengths, q_len, k_len):
    """``[B, 1, q_len, k_len]`` bool: True where the key is a real
    token."""
    keep = np.arange(k_len)[None, :] < np.asarray(lengths)[:, None]
    return np.broadcast_to(keep[:, None, None, :],
                           (len(lengths), 1, q_len, k_len)).copy()


# -- MultiHeadAttention ------------------------------------------------------------
def _masks():
    bool_mask = _padding_mask([6, 4], S, S)
    float_mask = np.where(bool_mask, 0.0, -1e4).astype(np.float32)
    float_mask += 0.1 * _x(B, 1, S, S, seed=9)
    return {"none": None, "bool": bool_mask, "float": float_mask}


@pytest.mark.parametrize("mask", ["none", "bool", "float"])
def test_mha_self_attention_as_jax(mask):
    jl, tl = _pair("MultiHeadAttention", D, H)
    assert list(tl.state_dict()) == list(jl.state_dict())
    m = _masks()[mask]
    kw = {} if m is None else dict(attn_mask=m)
    check_pair(jl, tl, [_x(B, S, D)], kwargs=kw, **TOL)


def test_mha_cross_attention_other_widths_as_jax():
    jl, tl = _pair("MultiHeadAttention", D, H, kdim=12, vdim=20)
    check_pair(jl, tl, [_x(B, S, D), _x(B, T, 12, seed=1),
                        _x(B, T, 20, seed=2)], grad_inputs=(0, 1, 2), **TOL)


def test_mha_cache_as_jax_and_equal_to_the_causal_forward():
    jl, tl = _pair("MultiHeadAttention", D, H)
    x = _x(B, S, D)
    jc = jl.gen_cache(jnp.asarray(x))
    tc = tl.gen_cache(torch.tensor(x))
    assert tc[0].shape == (B, 0, H, D // H)
    outs = []
    for t in range(S):
        jo, jc = jl(jnp.asarray(x[:, t:t + 1]), cache=jc)
        to, tc = tl(torch.tensor(x[:, t:t + 1]), cache=tc)
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                                   **TOL)
        np.testing.assert_allclose(tc[0].detach().numpy(),
                                   np.asarray(jc[0]), **TOL)
        outs.append(to)
    full = tl(torch.tensor(x),
              attn_mask=tnn.Transformer.generate_square_subsequent_mask(S))
    torch.testing.assert_close(torch.cat(outs, 1), full, **TOL)


def test_mha_flash_route_on_the_cpu_as_jax_dense(monkeypatch):
    """hd 64: the gate opens (forced); the port's plain flash version
    against the JAX MHA's dense route, forward and gradients."""
    seen = []

    def forced(q, k, attn_mask=None, dropout_p=0.0):
        seen.append(attn_mask is None and dropout_p == 0.0)
        return attn_mask is None and dropout_p == 0.0

    monkeypatch.setattr(_attn, "flash_eligible", forced)
    jl, tl = _pair("MultiHeadAttention", 128, 2)
    check_pair(jl, tl, [_x(B, 16, 128)], rtol=1e-4, atol=1e-5)
    assert seen and all(seen)


def test_square_subsequent_mask_is_bool_as_jax():
    t = tnn.Transformer.generate_square_subsequent_mask(5)
    j = jnn.Transformer.generate_square_subsequent_mask(5)
    assert t.dtype == torch.bool
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# -- encoder and decoder layers ------------------------------------------------
@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_encoder_layer_as_jax(pre_ln, act):
    jl, tl = _pair("TransformerEncoderLayer", D, H, FF, activation=act,
                   normalize_before=pre_ln)
    assert list(tl.state_dict()) == list(jl.state_dict())
    check_pair(jl, tl, [_x(B, S, D)],
               kwargs=dict(src_mask=_masks()["bool"]), **TOL)


@pytest.mark.parametrize("pre_ln", [False, True])
def test_decoder_layer_as_jax(pre_ln):
    jl, tl = _pair("TransformerDecoderLayer", D, H, FF,
                   normalize_before=pre_ln)
    assert list(tl.state_dict()) == list(jl.state_dict())
    kw = dict(tgt_mask=np.asarray(jnn.Transformer
                                  .generate_square_subsequent_mask(T)),
              memory_mask=_padding_mask([6, 3], T, S))
    check_pair(jl, tl, [_x(B, T, D), _x(B, S, D, seed=1)],
               grad_inputs=(0, 1), kwargs=kw, **TOL)


@pytest.mark.parametrize("pre_ln", [False, True])
def test_stacks_start_equal_and_match_jax(pre_ln):
    jpt.seed(3)
    jenc = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(
        D, H, FF, normalize_before=pre_ln), 3,
        jnn.LayerNorm(D) if pre_ln else None)
    gen = tpt.framework.random.default_generator()
    tpt.seed(3)
    layer = tnn.TransformerEncoderLayer(D, H, FF, normalize_before=pre_ln)
    before = gen.get_state()
    tenc = tnn.TransformerEncoder(layer, 3,
                                  tnn.LayerNorm(D) if pre_ln else None)
    if not pre_ln:
        assert torch.equal(gen.get_state(), before)  # the copies drew nothing
    assert tenc.layers[0] is layer
    sd = tenc.state_dict()
    for name in layer.state_dict():
        for i in (1, 2):
            assert torch.equal(sd[f"layers.0.{name}"], sd[f"layers.{i}.{name}"])
    assert list(sd) == list(jenc.state_dict())
    jenc.eval()
    bridged(jenc, tenc)
    check_pair(jenc, tenc, [_x(B, S, D)], **TOL)


@pytest.mark.parametrize("pre_ln", [False, True])
def test_full_transformer_as_jax(pre_ln):
    jl, tl = _pair("Transformer", D, H, 2, 2, FF, normalize_before=pre_ln)
    assert list(tl.state_dict()) == list(jl.state_dict())
    kw = dict(src_mask=_padding_mask([6, 4], S, S),
              tgt_mask=np.asarray(jnn.Transformer
                                  .generate_square_subsequent_mask(T)),
              memory_mask=_padding_mask([6, 4], T, S))
    check_pair(jl, tl, [_x(B, S, D), _x(B, T, D, seed=1)],
               grad_inputs=(0, 1), kwargs=kw, **TOL)


def test_transformer_defaults_are_transformer_base():
    tpt.seed(0)
    t = tnn.Transformer()
    assert t.d_model == 512 and t.nhead == 8
    assert len(t.encoder.layers) == 6 and len(t.decoder.layers) == 6
    assert t.encoder.layers[0].linear1.weight.shape == (512, 2048)
    assert t.encoder.layers[0].dropout1.p == 0.1
    assert t.encoder.layers[0].self_attn.dropout == 0.1


def test_cached_decoder_equals_the_uncached_causal_forward_of_both():
    jpt.seed(8)
    jdec = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(D, H, FF), 2)
    tdec = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(D, H, FF), 2)
    jdec.eval()
    bridged(jdec, tdec)
    tgt, mem = _x(B, T, D), _x(B, S, D, seed=1)
    mask = tnn.Transformer.generate_square_subsequent_mask(T)
    want = np.asarray(jdec(jnp.asarray(tgt), jnp.asarray(mem),
                           tgt_mask=jnp.asarray(mask.numpy())))
    full = tdec(torch.tensor(tgt), torch.tensor(mem), tgt_mask=mask)
    np.testing.assert_allclose(full.detach().numpy(), want, **TOL)
    cache = tdec.gen_cache(torch.tensor(mem))
    steps = []
    for t in range(T):
        out, cache = tdec(torch.tensor(tgt[:, t:t + 1]), torch.tensor(mem),
                          cache=cache)
        steps.append(out)
    assert cache[0][0].shape == (B, T, H, D // H)
    np.testing.assert_allclose(torch.cat(steps, 1).detach().numpy(), want,
                               **TOL)


def test_amp_o1_dtypes_and_loss_as_jax():
    jl, tl = _pair("TransformerEncoderLayer", D, H, FF)
    seen = {}
    for name, mod in tl.named_modules():
        if name in ("self_attn", "self_attn.q_proj", "norm1", "linear1"):
            mod.register_forward_hook(
                lambda m, i, o, name=name: seen.__setitem__(name, o.dtype))
    x = _x(B, S, D)
    with tauto_cast(level="O1"):
        to = tl(torch.tensor(x))
    with jauto_cast(level="O1"):
        jo = jl(jnp.asarray(x))
    assert seen == {"self_attn.q_proj": torch.bfloat16,
                    "self_attn": torch.bfloat16, "norm1": torch.float32,
                    "linear1": torch.bfloat16}
    assert to.dtype == torch.float32 and jo.dtype == jnp.float32
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=2e-2, atol=2e-2)
