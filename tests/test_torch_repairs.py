"""The repairs of ROADMAP Queue 3 items 1-3, each held against the JAX
package on the same inputs (CPU):

* ``nn.Linear`` and ``nn.LayerNorm`` take the reference's parameters, so
  a ``ParamAttr`` lands on the parameter it names: ``optimize_attr``,
  ``need_clip``, ``requires_grad`` (``not stop_gradient``) and whether
  there is a bias are exactly the JAX layer's;
* ``nn.functional.cross_entropy`` takes ``weight`` third and the
  reference's keywords, with the JAX function's results on the same numpy
  inputs (atol 1e-6: float32 log-softmax in another order);
  ``functional.dropout``/``nn.Dropout`` take ``axis`` and ``mode``: equal
  results where no random draw enters (eval mode), and in training the
  same structure of the mask (whole rows along the other axes, kept
  values unscaled under ``downscale_in_infer``);
* ``Model.eval_batch``/``evaluate`` return what the JAX package returns:
  0.0 under an ``inputs``-only spec (GPT), and for a labelled classifier
  the same loss (atol 1e-6).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.hapi import Model as JaxModel
from paddle_tpu.io import TensorDataset as JaxTensorDataset
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.nn.layer.layers import get_params_tree
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import gpt_from_jax_params
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.models import GPTConfig
from paddle_tpu_torch.nn import functional as TF


def _attrs(layer, torch_side):
    """(name, optimize_attr, need_clip, trainable) of each parameter."""
    out = []
    for name in ("weight", "bias"):
        p = getattr(layer, name, None)
        if p is None:
            out.append((name, None))
            continue
        trainable = p.requires_grad if torch_side else not p.stop_gradient
        out.append((name, getattr(p, "optimize_attr", None),
                    getattr(p, "need_clip", None), trainable))
    return out


LAYER_CASES = {
    "Linear weight lr 0.5": (
        lambda m: m.Linear(4, 8, m.ParamAttr(learning_rate=0.5))),
    "Linear no bias": lambda m: m.Linear(4, 8, bias_attr=False),
    "Linear frozen unclipped bias": lambda m: m.Linear(
        4, 8, None, m.ParamAttr(learning_rate=2.0, trainable=False,
                                need_clip=False)),
    "Linear named weight": lambda m: m.Linear(4, 8, "w0"),
    "LayerNorm ParamAttr": lambda m: m.LayerNorm(8, 1e-5, m.ParamAttr()),
    "LayerNorm no bias": lambda m: m.LayerNorm(
        8, 1e-5, m.ParamAttr(learning_rate=0.1), False),
    "LayerNorm default": lambda m: m.LayerNorm(8),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_param_attrs_match_jax(case):
    make = LAYER_CASES[case]
    assert _attrs(make(tnn), True) == _attrs(make(jnn), False)


def test_linear_and_layernorm_keep_their_callers_forms():
    lin = tnn.Linear(4, 8, device="cpu", dtype=torch.float64)
    assert lin.weight.dtype == torch.float64 and lin.bias is not None
    assert tuple(lin.weight.shape) == (8, 4)      # torch's [out, in]
    ln = tnn.LayerNorm([6], dtype=torch.bfloat16)
    assert ln.weight.dtype == torch.bfloat16 and ln._epsilon == 1e-5
    x = torch.randn(3, 6)
    assert torch.equal(tnn.LayerNorm(6, bias_attr=False)(x),
                       tnn.LayerNorm(6)(x))       # a zero bias adds 0
    with pytest.raises(ValueError, match="weight"):
        tnn.Linear(4, 8, weight_attr=False)


def _ce_inputs(seed, shape=(6, 5), axis=-1):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    n_cls = shape[axis]
    lshape = list(shape)
    del lshape[axis % len(shape)]
    label = rng.randint(0, n_cls, lshape).astype(np.int64)
    return x, label, rng.rand(n_cls).astype(np.float32) + 0.5


def _soft(x, axis=-1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


CE_CASES = {
    "weight third": dict(weight=True),
    "weight sum": dict(weight=True, reduction="sum"),
    "none": dict(reduction="none"),
    "ignore_index": dict(ignore=True),
    "ignore with weight": dict(ignore=True, weight=True),
    "label smoothing": dict(label_smoothing=0.1),
    "soft labels": dict(soft=True),
    "soft labels weight smoothing": dict(soft=True, weight=True,
                                         label_smoothing=0.2),
    "probabilities": dict(use_softmax=False),
    "axis 1 of 3": dict(shape=(3, 4, 5), axis=1),
    "label with a size-1 axis": dict(keepdim=True),
}


@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_matches_jax(case):
    c = dict(CE_CASES[case])
    shape, axis = c.pop("shape", (6, 5)), c.pop("axis", -1)
    x, label, w = _ce_inputs(len(case), shape, axis)
    kw = {}
    if c.pop("ignore", False):
        label[0] = -100
        label.flat[-1] = -100
    if c.pop("soft", False):
        label = _soft(np.random.RandomState(1).randn(*shape), axis)
        kw["soft_label"] = True
    if c.pop("keepdim", False):
        label = label[:, None]
    if not c.pop("use_softmax", True):
        x = _soft(x, axis)
        kw["use_softmax"] = False
    weight = w if c.pop("weight", False) else None
    kw.update(c, axis=axis)
    want = paddle.nn.functional.cross_entropy(
        paddle.to_tensor(x), paddle.to_tensor(label),
        None if weight is None else paddle.to_tensor(weight), **kw)
    got = TF.cross_entropy(torch.from_numpy(x), torch.from_numpy(label),
                           None if weight is None else torch.from_numpy(w),
                           **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               atol=1e-6, rtol=1e-6)


def test_dropout_in_eval_matches_jax():
    x = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    for mode in ("upscale_in_train", "downscale_in_infer"):
        want = paddle.nn.functional.dropout(paddle.to_tensor(x), p=0.3,
                                            training=False, mode=mode)
        got = TF.dropout(torch.from_numpy(x), p=0.3, training=False,
                         mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                   rtol=1e-6)
        layer = tnn.Dropout(0.3, mode=mode).eval()
        np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(),
                                   np.asarray(want.numpy()), rtol=1e-6)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("axis", [None, 0, [0, 2]])
def test_dropout_masks_have_the_jax_structure(axis, mode):
    """In training: zeros where the mask drops, each kept value ``x /
    (1 - p)`` (upscale) or ``x`` (downscale), and with ``axis`` a mask
    drawn over those axes only, constant along the others: in both
    packages."""
    x = np.random.RandomState(1).rand(8, 6, 5).astype(np.float32) + 1.0
    p, keep = 0.5, (1.0 if mode == "downscale_in_infer" else 2.0)
    paddle.seed(3)
    outs = [np.asarray(paddle.nn.functional.dropout(
                paddle.to_tensor(x), p=p, axis=axis, mode=mode).numpy()),
            TF.dropout(torch.from_numpy(x), p=p, axis=axis,
                       mode=mode).numpy()]
    for out in outs:
        kept = out != 0
        np.testing.assert_allclose(out[kept], keep * x[kept], rtol=1e-6)
        assert 0 < kept.mean() < 1
        if axis is not None:
            axes = {axis} if isinstance(axis, int) else set(axis)
            other = tuple(i for i in range(3) if i not in axes)
            assert (kept.all(axis=other) | (~kept).all(axis=other)).all()


def _gpt_pair(seed):
    paddle.seed(seed)
    jnet = JaxGPT(JaxGPTConfig.tiny(), lm_loss_chunks=1)
    params = {k: np.asarray(v) for k, v in get_params_tree(jnet).items()}
    tnet = gpt_from_jax_params(params, GPTConfig.tiny(), device="cpu",
                               lm_loss_chunks=1)
    return jnet, tnet


def _gpt_batches(seed, n=4, seq=16):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, JaxGPTConfig.tiny().vocab_size,
                      (n, seq)).astype(np.int64)
    return ids, np.concatenate([ids[:, 1:], np.full((n, 1), -100)], 1)


def test_gpt_eval_batch_and_evaluate_equal_the_jax_package():
    """An ``inputs``-only spec: both packages give 0.0 from ``eval_batch``
    and ``evaluate``; the loss both networks compute is predict's first
    output, within 1e-5 (float32 sums in another order)."""
    jnet, tnet = _gpt_pair(11)
    ids, labels = _gpt_batches(12)
    jm = JaxModel(jnet, inputs=["ids", "labels"])
    jm.prepare(loss=lambda loss, logits: loss)
    tm = Model(tnet, inputs=["ids", "labels"], device="cpu")
    tm.prepare(loss=lambda loss, logits: loss)
    for i in (0, 2):
        batch = [ids[i:i + 2], labels[i:i + 2]]
        assert tm.eval_batch(batch) == jm.eval_batch(batch) == 0.0
    assert tm.evaluate(TensorDataset([ids, labels]), batch_size=2,
                       verbose=0) == \
        jm.evaluate(JaxTensorDataset([ids, labels]), batch_size=2,
                    verbose=0) == {"loss": 0.0}
    want = jm.predict(JaxTensorDataset([ids, labels]), batch_size=2)[0]
    got = tm.predict(TensorDataset([ids, labels]), batch_size=2)[0]
    np.testing.assert_allclose(np.ravel(got), np.ravel(want), rtol=1e-5)
    assert all(np.isfinite(np.ravel(got))) and float(np.ravel(got)[0]) > 0


def test_classifier_eval_batch_and_evaluate_equal_the_jax_package():
    rng = np.random.RandomState(5)
    x = rng.randn(10, 6).astype(np.float32)
    y = rng.randint(0, 3, 10).astype(np.int64)
    w = (0.5 * rng.randn(6, 3)).astype(np.float32)
    b = (0.1 * rng.randn(3)).astype(np.float32)
    jnet = paddle.nn.Linear(6, 3)
    jnet.set_state_dict({"weight": paddle.to_tensor(w),
                         "bias": paddle.to_tensor(b)})
    jm = JaxModel(jnet)
    jm.prepare(loss=lambda out, lbl: paddle.nn.functional.cross_entropy(
        out, lbl))
    tnet = tnn.Linear(6, 3)
    with torch.no_grad():
        tnet.weight.copy_(torch.from_numpy(w.T.copy()))
        tnet.bias.copy_(torch.from_numpy(b))
    tm = Model(tnet, device="cpu")
    tm.prepare(loss=lambda out, lbl: TF.cross_entropy(out, lbl))
    for i in (0, 5):
        np.testing.assert_allclose(tm.eval_batch([x[i:i + 5]], [y[i:i + 5]]),
                                   jm.eval_batch([x[i:i + 5]], [y[i:i + 5]]),
                                   atol=1e-6)
    np.testing.assert_allclose(
        tm.evaluate(TensorDataset([x, y]), batch_size=5,
                    verbose=0)["loss"],
        jm.evaluate(JaxTensorDataset([x, y]), batch_size=5,
                    verbose=0)["loss"], atol=1e-6)


def test_train_batch_returns_a_device_scalar_without_numpy():
    jnet, tnet = _gpt_pair(13)
    from paddle_tpu_torch.optimizer import SGD
    tm = Model(tnet, inputs=["ids", "labels"], device="cpu")
    tm.prepare(SGD(0.0, parameters=tnet.parameters()),
               loss=lambda loss, logits: loss)
    ids, labels = _gpt_batches(14, n=2)
    loss = tm.train_batch([ids, labels], return_numpy=False)
    assert torch.is_tensor(loss) and loss.dim() == 0
    assert isinstance(tm.train_batch([ids, labels]), float)
