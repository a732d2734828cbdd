"""The repairs of ROADMAP Queue 3's items, each held against the JAX
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
  the same loss (atol 1e-6);
* the top-level namespace: every public name of ``paddle_tpu`` (but the
  ``from __future__ import annotations`` feature its ``__init__`` leaves
  behind) exists in ``paddle_tpu_torch`` or raises ``NotImplementedError``
  naming its ROADMAP Queue 1 item; the small ones behave as the JAX
  package's;
* ``chip_smoke.py`` phase 3d's int8 check holds each int8 engine against
  itself on another device (``int8_one_slot_check``): run here with both
  copies on the CPU, on phase 3d's float32 model as built and on the
  weights a ``Linear`` drawn before ``_init_weights`` shifts (the weights
  of the run that found the fault), the int8 fused engine passes on both
  (the gather engine's check is the same function), while the check it
  replaced, the int8 fused engine's tokens against the int8 gather
  engine's, fails on the shifted ones: the gather prefill attends over
  the float K/V, the fused prefill over the int8 codes (0.019-0.031 apart
  in the first step's logits on either weight set, beyond
  ``QUANT_GEN_TOL`` = 5e-3).
"""
import pathlib
import re
import sys

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


def _public_reference_names():
    return sorted(n for n in dir(paddle) if not n.startswith("_")
                  and n != "annotations")


@pytest.mark.parametrize("name", _public_reference_names())
def test_a_reference_name_is_ported_or_raises_its_item(name):
    import paddle_tpu_torch as pt
    try:
        getattr(pt, name)
    except NotImplementedError as e:
        assert re.search(r"Queue 1 item [0-9]", str(e)), str(e)


def _shared_modules():
    """Every module path of ``paddle_tpu_torch`` (below the top level)
    that names a module of ``paddle_tpu`` too, read from the file trees
    (nothing is imported to collect them)."""
    root = pathlib.Path(__file__).resolve().parent.parent
    out = []
    for path in sorted((root / "paddle_tpu_torch").rglob("*.py")):
        rel = path.relative_to(root / "paddle_tpu_torch").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        if not parts:
            continue
        ref = root / "paddle_tpu" / pathlib.Path(*parts)
        if ref.with_suffix(".py").exists() or \
                (ref / "__init__.py").exists():
            out.append(".".join(parts))
    return out


@pytest.mark.parametrize("module", _shared_modules())
def test_every_module_name_is_ported_or_raises_its_item(module):
    """Each identifier of the JAX module's ``__all__`` exists in the
    port's module or raises ``NotImplementedError`` naming its Queue 1
    item (a name that is not an identifier, as the ``'<lambda>'`` the
    JAX ``nn.functional`` appends, is skipped); every failing name of
    the module is reported at once."""
    import importlib
    ref = importlib.import_module(f"paddle_tpu.{module}")
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    bad = {}
    for name in getattr(ref, "__all__", ()):
        if not name.isidentifier():
            continue
        try:
            getattr(port, name)
        except NotImplementedError as e:
            if not re.search(r"Queue 1 item [0-9]", str(e)):
                bad[name] = str(e)
        except Exception as e:  # noqa: BLE001  (what the sweep reports)
            bad[name] = f"{type(e).__name__}: {e}"
    assert not bad, bad


def test_the_module_sweep_reaches_the_numerics_and_quantization():
    """The ``__all__`` sweep above takes in the quantization, numerics,
    dataset and hub modules, every one of them now ported (none raises
    ``NotImplementedError`` at the top level or in ``nn``)."""
    import paddle_tpu_torch as pt
    swept = set(_shared_modules())
    for module in ("quantization", "quantization.passes", "nn.quant",
                   "nn.utils", "linalg", "fft", "signal", "distribution",
                   "distribution.transform", "sparse", "sparse.nn",
                   "dataset", "dataset.common", "dataset.mnist",
                   "dataset.cifar", "dataset.wmt16", "hub"):
        assert module in swept, module
    for name in ("quantization", "dataset", "hub", "linalg", "fft",
                 "signal", "distribution", "sparse"):
        assert getattr(pt, name).__name__ == f"paddle_tpu_torch.{name}"
    for name in ("utils", "quant"):
        assert getattr(pt.nn, name).__name__ == f"paddle_tpu_torch.nn.{name}"


def test_the_repaired_module_names():
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework import program_registry
    from paddle_tpu_torch.models import generation
    from paddle_tpu_torch import serving
    assert amp.amp_guard is amp.auto_cast
    for mod, name, item in (
            (generation, "shard_params_megatron", 4),
            (generation, "build_sharded_fused_step_fn", 4),
            (serving, "PlanError", 5), (serving.engine, "PlanError", 5),
            (program_registry, "aot_site", 5),
            (program_registry, "analyze_callable", 5)):
        with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
            getattr(mod, name)
        with pytest.raises(AttributeError):
            getattr(mod, name + "_not_a_reference_name")


def test_the_small_top_level_names_behave_as_the_jax_ones():
    import paddle_tpu_torch as pt
    assert isinstance(torch.ones(2), pt.Tensor) and issubclass(
        torch.nn.Parameter, pt.Tensor) and not isinstance([1.0], pt.Tensor)
    old = pt.get_device()
    pt.set_device("cpu")
    try:
        made = pt.Tensor([1.0, 2.0], stop_gradient=False, name="x")
    finally:
        pt.set_device(old)
    assert made.requires_grad and made.device.type == "cpu"
    assert isinstance(torch.float32, pt.dtype)
    assert pt.bool_ is torch.bool
    assert pt.get_default_dtype() == paddle.get_default_dtype() == "float32"
    try:
        pt.set_default_dtype("float64")
        assert pt.to_tensor([1.5], place="cpu").dtype == torch.float64
        with pytest.raises(TypeError):
            pt.set_default_dtype("int32")
    finally:
        pt.set_default_dtype("float32")
    assert pt.to_tensor([1.5], place="cpu").dtype == torch.float32
    x = torch.ones(2, requires_grad=True)
    with pt.no_grad():
        with pt.set_grad_enabled(True):
            assert (x * 2).requires_grad
    assert pt.is_compiled_with_tpu() is False
    assert pt.CUDAPinnedPlace().device_type == "cpu"
    assert pt.CPUPlace() == pt.CPUPlace(0) != pt.CUDAPlace(0)
    pt.seed(5)
    state = pt.get_cuda_rng_state()
    a = pt.framework.random.get_generator("cpu")
    first = torch.rand(3, generator=a)
    pt.set_cuda_rng_state(state)
    assert torch.equal(torch.rand(3, generator=pt.framework.random
                                  .get_generator("cpu")), first)
    flags = pt.get_flags(["FLAGS_check_nan_inf"])
    assert flags == paddle.get_flags(["FLAGS_check_nan_inf"])
    assert pt.Model.__module__ == "paddle_tpu_torch.hapi.model"
    assert callable(pt.statusz) and hasattr(pt.metrics, "to_prometheus")
    assert pt.models.GPTForPretraining and pt.serving.GenerationEngine


def _phase_3d_model(shifted):
    """Phase 3d's float32 model, prompts and tokens; ``shifted``: each
    ``Linear`` of the GPT blocks draws its default initializer first, so
    ``_init_weights`` draws from a later generator state."""
    sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))
    import chip_smoke
    from paddle_tpu_torch.models import gpt as gpt_module
    constant = gpt_module.Constant
    if shifted:
        gpt_module.Constant = lambda value: None
    try:
        return chip_smoke, chip_smoke.gather_f32_setup()
    finally:
        gpt_module.Constant = constant


def _run_int8(cs, net, prompts, new, kw, one_slot=True):
    spy = type(net.gpt).logits.__get__(net.gpt)
    extra = dict(num_slots=1, alone=len(prompts)) if one_slot else {}
    return cs.engine_run(net, prompts, new, spy, **extra, **kw)[0]


@pytest.mark.parametrize("shifted", [False, True],
                         ids=["as built", "shifted"])
def test_phase_3d_int8_checks_pass_on_both_weight_sets(shifted):
    import copy
    import paddle_tpu_torch as pt
    old = pt.get_device()
    pt.set_device("cpu")
    try:
        cs, (net, prompts, new) = _phase_3d_model(shifted)
        other = copy.deepcopy(net)
        kw = cs.INT8_FUSED_F32
        concurrent = _run_int8(cs, other, prompts, new, kw, one_slot=False)
        line, _ = cs.int8_one_slot_check("int8 fused engine", net, other,
                                         prompts, new, kw, concurrent)
        assert f"limit {cs.QUANT_GEN_TOL}" in line
    finally:
        pt.set_device(old)


def test_the_replaced_int8_check_fails_on_the_shifted_weights():
    import paddle_tpu_torch as pt
    old = pt.get_device()
    pt.set_device("cpu")
    try:
        cs, (net, prompts, new) = _phase_3d_model(shifted=True)
        rec = {}
        for what, kw in (("gather", cs.INT8_GATHER_F32),
                         ("fused", cs.INT8_FUSED_F32)):
            logits = []

            def spy(h, _gpt=net.gpt, _rec=logits):
                out = type(_gpt).logits(_gpt, h)
                _rec.append(out[:, -1].float())
                return out

            outs, _ = cs.engine_run(net, prompts, new, spy, num_slots=1,
                                    alone=len(prompts), **kw)
            rec[what] = outs, torch.cat(logits).view(len(prompts), new, -1)
        first = (rec["gather"][1][:, 0] - rec["fused"][1][:, 0]).abs()
        assert first.max() > cs.QUANT_GEN_TOL
        top2 = rec["gather"][1].topk(2, dim=-1).values
        ties = cs.first_near_tie(top2[..., 0] - top2[..., 1],
                                 cs.QUANT_GEN_TOL)
        with pytest.raises(AssertionError, match="before its first"):
            cs.hold_tokens("int8 fused engine", rec["fused"][0],
                           rec["gather"][0], prompts, ties)
    finally:
        pt.set_device(old)
