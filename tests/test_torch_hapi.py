"""``Model`` in the port against the JAX package's, on the CPU: the GPT-2
training recipe through ``fit``, evaluation, prediction, the metrics,
the callbacks, and checkpoints written and read by either package.

* The recipe (warmup then cosine decay, a global-norm clip at 1.0, no
  decay on biases and LayerNorm) through both packages' ``fit`` from the
  same GPT-2-tiny weights, float32 on the dense loss path: the lr of
  every step equal, the losses within 1e-5 (float32 sums in another
  order, as ``tests/test_torch_train.py`` holds ``fit``).
* ``evaluate``, ``predict`` and the metrics of a classifier on the same
  weights: losses within 1e-6, metrics equal (the same numpy code on
  equal predictions), predictions within 1e-6.
* ``EarlyStopping`` and ``ReduceLROnPlateau`` act at the same epochs;
  ``VisualDL`` writes the same records.
* A port checkpoint loads into a fresh ``Model`` and trains on exactly;
  a JAX ``Model.save`` checkpoint resumes in the port through
  ``convert`` (the two steps after it within 1e-5); a port ``.pdparams``
  opens in ``paddle_tpu.load``.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import metric as jmetric
from paddle_tpu import optimizer as jopt
from paddle_tpu.hapi import Model as JaxModel
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.io import TensorDataset as JaxTensorDataset
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.nn.layer.layers import get_params_tree
from paddle_tpu_torch import callbacks as tcb
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import (gpt_from_jax_params,
                                      gpt_to_numpy_params,
                                      opt_state_from_jax, opt_state_to_jax)
from paddle_tpu_torch.framework.io import load as tload
from paddle_tpu_torch.framework.io import save as tsave
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.models import GPTConfig
from paddle_tpu_torch.nn import ClipGradByGlobalNorm

LR = 1e-3


def _no_decay(name):
    """The recipe's decay filter: no bias and no LayerNorm parameter."""
    return not (name.endswith(".bias") or ".ln_" in name
                or name.startswith("gpt.ln_f"))


def _recipe(mod_opt, mod_lr, clip, params, steps):
    sched = mod_lr.LinearWarmup(
        mod_lr.CosineAnnealingDecay(LR, T_max=steps), warmup_steps=2,
        start_lr=0.0, end_lr=LR)
    return mod_opt.AdamW(sched, parameters=params, weight_decay=0.1,
                         apply_decay_param_fun=_no_decay,
                         grad_clip=clip(1.0))


def _gpt(seed):
    paddle.seed(seed)
    jnet = JaxGPT(JaxGPTConfig.tiny(), lm_loss_chunks=1)
    params = {k: np.asarray(v) for k, v in get_params_tree(jnet).items()}
    return jnet, params


def _batches(seed, n, batch=2, seq=16):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, JaxGPTConfig.tiny().vocab_size,
                      (n * batch, seq)).astype(np.int64)
    labels = np.concatenate([ids[:, 1:], np.full((n * batch, 1), -100)], 1)
    return ids, labels


class _Seen:
    """Loss and lr of every step (read before the lr scheduler steps)."""

    def __init__(self):
        super().__init__()
        self.loss, self.lr = [], []

    def on_train_batch_end(self, step, logs=None):
        self.loss.append(logs["loss"])
        self.lr.append(self.model._optimizer.get_lr())


class _JaxSeen(_Seen, jcb.Callback):
    pass


class _PortSeen(_Seen, tcb.Callback):
    pass


def _jax_fit_gpt(params_seed, ids, labels, epochs, steps):
    jnet, params = _gpt(params_seed)
    jm = JaxModel(jnet, inputs=["ids", "labels"])
    jm.prepare(_recipe(jopt, jopt.lr, JaxClip, jnet.parameters(), steps),
               loss=lambda loss, logits: loss)
    seen = _JaxSeen()
    jm.fit(JaxTensorDataset([ids, labels]), batch_size=2, epochs=epochs,
           shuffle=False, log_freq=1, verbose=0, callbacks=[seen])
    return jm, jnet, params, seen


def _port_model(params, steps, chunks=1):
    net = gpt_from_jax_params(params, GPTConfig.tiny(), device="cpu",
                              lm_loss_chunks=chunks)
    model = Model(net, inputs=["ids", "labels"], device="cpu")
    model.prepare(_recipe(topt, topt.lr, ClipGradByGlobalNorm,
                          net.named_parameters(), steps),
                  loss=lambda loss, logits: loss)
    return model, net


def test_recipe_fit_matches_jax_fit():
    ids, labels = _batches(1, 4)
    _, _, params, want = _jax_fit_gpt(0, ids, labels, epochs=2, steps=8)
    model, _ = _port_model(params, 8)
    got = _PortSeen()
    model.fit(TensorDataset([ids, labels]), batch_size=2, epochs=2,
              shuffle=False, log_freq=1, verbose=0, callbacks=[got])
    assert got.lr == want.lr and len(got.lr) == 8
    assert got.lr[0] == 0.0 and got.lr[2] == LR        # warmup, then cosine
    assert got.lr[3] < LR
    np.testing.assert_allclose(got.loss, want.loss, atol=1e-5, rtol=0)


def test_clip_norm_bites_at_random_init():
    """At random init the GPT gradient norm is above 1.0: the clip scales
    every gradient by 1 / norm, reading the raw gradients."""
    ids, labels = _batches(2, 1)
    _, params = _gpt(3)
    model, net = _port_model(params, 4)
    norms = []
    clip = model._optimizer._grad_clip
    orig = clip.clip_with_norm

    def spy(pairs):
        out, norm = orig(pairs)
        norms.append(float(norm))
        return out, norm

    clip.clip_with_norm = spy
    model.train_batch([ids, labels])
    assert len(norms) == 1 and norms[0] > 1.0


# --------------------------------------------------- evaluate / predict
N_CLASSES = 4


def _classifier_data(seed, n=24, d=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = rng.randint(0, N_CLASSES, n).astype(np.int64)
    w = (0.5 * rng.randn(d, N_CLASSES)).astype(np.float32)
    b = (0.1 * rng.randn(N_CLASSES)).astype(np.float32)
    return x, y, w, b


def _jax_classifier(w, b, lr=0.0, metrics=()):
    net = paddle.nn.Linear(w.shape[0], N_CLASSES)
    net.set_state_dict({"weight": paddle.to_tensor(w),
                        "bias": paddle.to_tensor(b)})
    m = JaxModel(net)
    m.prepare(jopt.SGD(lr, parameters=net.parameters()),
              loss=lambda out, y: paddle.nn.functional.cross_entropy(out, y),
              metrics=list(metrics))
    return m


def _port_classifier(w, b, lr=0.0, metrics=()):
    from paddle_tpu_torch.nn import functional as F
    net = torch.nn.Linear(w.shape[0], N_CLASSES)
    with torch.no_grad():
        net.weight.copy_(torch.from_numpy(w.T.copy()))
        net.bias.copy_(torch.from_numpy(b))
    m = Model(net, device="cpu")
    m.prepare(topt.SGD(lr, parameters=net.parameters()),
              loss=lambda out, y: F.cross_entropy(out, y),
              metrics=list(metrics))
    return m


def test_evaluate_and_predict_match_jax():
    x, y, w, b = _classifier_data(4)
    jm = _jax_classifier(w, b, metrics=[jmetric.Accuracy(topk=(1, 2))])
    tm = _port_classifier(w, b, metrics=[tmetric.Accuracy(topk=(1, 2))])
    want = jm.evaluate(JaxTensorDataset([x, y]), batch_size=5, verbose=0)
    got = tm.evaluate(TensorDataset([x, y]), batch_size=5, verbose=0)
    assert sorted(got) == sorted(want) == ["acc_top1", "acc_top2", "loss"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)
    # evaluate's loss is the mean of the batches' eval_batch losses
    per = [tm.eval_batch([x[i:i + 5]], [y[i:i + 5]])[0]
           for i in range(0, len(x), 5)]
    np.testing.assert_allclose(got["loss"], np.mean(per), atol=1e-7)
    for stack in (False, True):
        pw = jm.predict(JaxTensorDataset([x, y]), batch_size=5,
                        stack_outputs=stack)
        pg = tm.predict(TensorDataset([x, y]), batch_size=5,
                        stack_outputs=stack)
        assert len(pg) == len(pw) == 1
        for a, bb in zip(pg[0] if not stack else pg,
                         pw[0] if not stack else pw):
            np.testing.assert_allclose(a, bb, atol=1e-6, rtol=0)
    assert pg[0].shape == (len(x), N_CLASSES)


def test_eval_and_predict_batch_run_without_grad_in_eval_mode():
    x, y, w, b = _classifier_data(5)
    tm = _port_classifier(w, b)
    modes = []
    tm.network.register_forward_hook(
        lambda mod, a, out: modes.append((mod.training,
                                          torch.is_grad_enabled())))
    loss = tm.eval_batch([x], [y])
    out = tm.predict_batch([x])
    assert isinstance(loss, float) and isinstance(out[0], np.ndarray)
    assert modes == [(False, False), (False, False)]
    assert tm.network.training                     # restored
    assert tm.eval_batch([x]) == 0.0               # no labels, no spec


def test_gpt_eval_loss_is_the_loss_of_the_batch():
    """A network that takes its labels among its inputs (an ``inputs``
    spec) has no label batch, so ``eval_batch`` and ``evaluate`` give a
    loss of 0.0, as the JAX package's eval step does; the loss of the
    batch is the network's own first output, which ``predict_batch``
    returns."""
    ids, labels = _batches(6, 2)
    _, params = _gpt(7)
    model, net = _port_model(params, 4)
    per = [model.eval_batch([ids[i:i + 2], labels[i:i + 2]])
           for i in (0, 2)]
    assert per == [0.0, 0.0]
    logs = model.evaluate(TensorDataset([ids, labels]), batch_size=2,
                          verbose=0)
    assert logs == {"loss": 0.0}
    with torch.no_grad():
        want = [net.eval()(torch.from_numpy(ids[i:i + 2]),
                           torch.from_numpy(labels[i:i + 2]))[0].item()
                for i in (0, 2)]
    got = [float(model.predict_batch([ids[i:i + 2], labels[i:i + 2]])[0])
           for i in (0, 2)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


METRIC_CASES = {
    "Accuracy": (lambda m: m.Accuracy(topk=(1, 3)), "multiclass"),
    "Accuracy_top1": (lambda m: m.Accuracy(), "multiclass"),
    "Precision": (lambda m: m.Precision(), "binary"),
    "Recall": (lambda m: m.Recall(), "binary"),
    "Auc": (lambda m: m.Auc(num_thresholds=255), "binary"),
    "Auc_two_columns": (lambda m: m.Auc(num_thresholds=4095), "binary2"),
}


@pytest.mark.parametrize("name", sorted(METRIC_CASES))
def test_metrics_match_jax(name):
    make, kind = METRIC_CASES[name]
    rng = np.random.RandomState(len(name))
    jm, tm = make(jmetric), make(tmetric)
    assert tm.name() == jm.name()
    for _ in range(3):
        if kind == "multiclass":
            pred = rng.rand(16, 5).astype(np.float32)
            label = rng.randint(0, 5, (16, 1)).astype(np.int64)
            a = jm.update(jm.compute(pred, label))
            b = tm.update(tm.compute(torch.from_numpy(pred),
                                     torch.from_numpy(label)))
            assert b == a
        else:
            pred = rng.rand(16, 2 if kind == "binary2" else 1).astype(
                np.float32)
            label = rng.randint(0, 2, (16, 1)).astype(np.int64)
            jm.update(pred, label)
            tm.update(torch.from_numpy(pred), torch.from_numpy(label))
    assert tm.accumulate() == jm.accumulate()
    tm.reset()
    jm.reset()
    assert tm.accumulate() == jm.accumulate()


def test_accuracy_function_matches_jax():
    rng = np.random.RandomState(9)
    pred = rng.rand(20, 6).astype(np.float32)
    label = rng.randint(0, 6, 20).astype(np.int64)
    for k in (1, 2, 5):
        assert tmetric.accuracy(torch.from_numpy(pred),
                                torch.from_numpy(label), k=k) == \
            jmetric.accuracy(pred, label, k=k)


def test_prepare_type_checks_metrics():
    _, _, w, b = _classifier_data(1)
    with pytest.raises(TypeError, match="Metric"):
        _port_classifier(w, b, metrics=["acc"])


# ------------------------------------------------------------ callbacks
def _fit_classifier(pkg, callbacks, epochs, lr=0.0, **kw):
    x, y, w, b = _classifier_data(8)
    if pkg == "jax":
        m, ds = _jax_classifier(w, b, lr), JaxTensorDataset
        hist = jcb.History()
    else:
        m, ds = _port_classifier(w, b, lr), TensorDataset
        hist = tcb.History()
    m.fit(ds([x[:16], y[:16]]), eval_data=ds([x[16:], y[16:]]),
          batch_size=4, epochs=epochs, shuffle=False, verbose=0,
          callbacks=callbacks + [hist], **kw)
    return m, hist


def test_early_stopping_stops_at_the_same_epoch():
    """lr 0: the eval loss never improves after the first evaluation, so
    patience 2 stops after the third."""
    runs = {}
    for pkg, mod in (("jax", jcb), ("port", tcb)):
        stop = mod.EarlyStopping(monitor="loss", patience=2, verbose=0)
        _, hist = _fit_classifier(pkg, [stop], epochs=10)
        runs[pkg] = (len(hist.history["loss"]), stop.wait, stop.best)
    assert runs["port"][:2] == runs["jax"][:2] == (3, 2)
    np.testing.assert_allclose(runs["port"][2], runs["jax"][2], atol=1e-6)


def test_reduce_lr_on_plateau_acts_at_the_same_epochs():
    lrs = {}
    for pkg, mod in (("jax", jcb), ("port", tcb)):
        seen = []
        red = mod.ReduceLROnPlateau(monitor="loss", factor=0.5, patience=1,
                                    verbose=0, cooldown=1)

        class Lr(mod.Callback):
            def on_epoch_begin(self, epoch, logs=None):
                seen.append(self.model._optimizer.get_lr())

        # a tiny lr: the eval loss moves by less than min_delta
        _fit_classifier(pkg, [red, Lr()], epochs=7, lr=1e-9)
        lrs[pkg] = seen
    assert lrs["port"] == lrs["jax"]
    assert lrs["port"][-1] < lrs["port"][0]


def test_visualdl_writes_the_same_records(tmp_path):
    records = {}
    for pkg, mod in (("jax", jcb), ("port", tcb)):
        d = tmp_path / pkg
        _fit_classifier(pkg, [mod.VisualDL(log_dir=str(d))], epochs=2,
                        lr=0.1, log_freq=1)
        records[pkg] = [json.loads(line) for line in
                        (d / "scalars.jsonl").read_text().splitlines()]
    got, want = records["port"], records["jax"]
    assert [(r["tag"], r["step"]) for r in got] == \
        [(r["tag"], r["step"]) for r in want]
    assert {r["tag"] for r in got} == {"train/loss", "epoch/loss",
                                       "eval/loss"}
    np.testing.assert_allclose([r["value"] for r in got],
                               [r["value"] for r in want], atol=1e-5)


def test_config_callbacks_adds_scheduler_history_and_checkpoint(tmp_path):
    from paddle_tpu_torch.hapi.callbacks import config_callbacks
    cbks = config_callbacks([], verbose=0, save_dir=str(tmp_path),
                            save_freq=2)
    kinds = [type(c).__name__ for c in cbks.callbacks]
    assert kinds == ["LRScheduler", "ModelCheckpoint", "History"]
    assert cbks.callbacks[1].save_freq == 2


# ---------------------------------------------------------- checkpoints
def test_fit_save_dir_and_load_resume_exactly(tmp_path):
    """``fit(save_dir=, save_freq=2)`` writes epochs 0 and 2 and
    ``final``; a fresh ``Model`` loading ``final`` evaluates and then
    trains exactly as the live one."""
    ids, labels = _batches(10, 2)
    _, params = _gpt(11)
    live, _ = _port_model(params, 6, chunks=2)
    data = TensorDataset([ids, labels])
    live.fit(data, eval_data=data, batch_size=2, epochs=3, shuffle=False,
             verbose=0, save_dir=str(tmp_path), save_freq=2)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["0.pdopt", "0.pdparams", "2.pdopt", "2.pdparams",
                     "final.pdopt", "final.pdparams"]
    fresh, _ = _port_model(_gpt(12)[1], 6, chunks=2)
    fresh.load(str(tmp_path / "final"))
    assert fresh._optimizer._step_count == live._optimizer._step_count == 6
    assert fresh._optimizer.get_lr() == live._optimizer.get_lr()
    assert fresh.evaluate(data, batch_size=2, verbose=0) == \
        live.evaluate(data, batch_size=2, verbose=0)
    assert fresh.train_batch([ids[:2], labels[:2]]) == \
        live.train_batch([ids[:2], labels[:2]])
    assert fresh.train_batch([ids[2:], labels[2:]]) == \
        live.train_batch([ids[2:], labels[2:]])


def test_load_skip_mismatch_and_reset_optimizer(tmp_path):
    x, y, w, b = _classifier_data(13)
    a = _port_classifier(w, b, lr=0.1)
    a.train_batch([x], [y])
    a.save(str(tmp_path / "a"))
    other = torch.nn.Sequential()
    other.weight = torch.nn.Parameter(torch.zeros(N_CLASSES, 6))
    other.extra = torch.nn.Parameter(torch.zeros(3))
    m = Model(other, device="cpu")
    m.prepare(topt.SGD(0.1, parameters=other.parameters()))
    with pytest.raises(RuntimeError):
        m.load(str(tmp_path / "a"))
    m.load(str(tmp_path / "a"), skip_mismatch=True, reset_optimizer=True)
    assert torch.equal(other.weight, a.network.weight)
    assert m._optimizer._step_count == 0


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package's ``fit`` trains 4 steps and saves; the port loads
    its ``.pdparams`` and ``.pdopt`` (through ``opt_state_from_jax``) and
    the next two steps' losses agree with the JAX package's within 1e-5.
    The second depends on the carried moments, step and scheduler."""
    ids, labels = _batches(14, 4)
    jm, _, _, _ = _jax_fit_gpt(15, ids, labels, epochs=1, steps=8)
    path = str(tmp_path / "jax")
    jm.save(path)
    jstate = tload(path + ".pdopt")
    assert "LR_Scheduler" in jstate and jstate["@step"] == 4
    params = tload(path + ".pdparams")
    model, net = _port_model(params, 8)
    opt = model._optimizer
    opt.set_state_dict(opt_state_from_jax(jstate, net, opt))
    assert opt._step_count == 4 and opt.get_lr() == jm._optimizer.get_lr()
    want = [jm.train_batch([ids[i:i + 2], labels[i:i + 2]]) for i in (0, 2)]
    got = [model.train_batch([ids[i:i + 2], labels[i:i + 2]])
           for i in (0, 2)]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the inverse gives back the JAX layout and keys
    back = opt_state_to_jax(opt.state_dict(), net, opt)
    assert sorted(back) == sorted(jstate)
    key = "gpt.blocks.0.attn.q_proj.weight_moment1"
    assert back[key].shape == tuple(jstate[key].shape)


def test_port_pdparams_open_in_the_jax_package(tmp_path):
    """bf16, float16 and float32 tensors and nested values survive a
    port ``save`` read by ``paddle_tpu.load`` and back."""
    _, params = _gpt(16)
    net = gpt_from_jax_params(params, GPTConfig.tiny(), device="cpu")
    state = {k: v.to(torch.bfloat16) if "wte" in k else v
             for k, v in net.state_dict().items()}
    state["half"] = torch.arange(4, dtype=torch.float16)
    state["nested"] = {"step": 3, "lst": [torch.ones(2), 1.5]}
    path = str(tmp_path / "port.pdparams")
    tsave(state, path)
    got = paddle.load(path)
    for k, v in state.items():
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(
                np.asarray(got[k].astype("float32").numpy()),
                v.float().numpy(), err_msg=k)
    assert str(got["gpt.wte.weight"].dtype).endswith("bfloat16")
    assert got["nested"]["step"] == 3
    back = tload(path)
    assert back["gpt.wte.weight"].dtype == torch.bfloat16
    assert torch.equal(back["gpt.wte.weight"], state["gpt.wte.weight"])
    assert torch.equal(back["half"], state["half"])
    # and a JAX-written file opens in the port
    paddle.save({"w": paddle.to_tensor(np.ones(3, np.float32))},
                str(tmp_path / "j.pdparams"))
    assert torch.equal(tload(str(tmp_path / "j.pdparams"))["w"],
                       torch.ones(3))
    trained = gpt_to_numpy_params(net)
    assert set(trained) == set(params)


def test_what_is_not_ported_raises_naming_its_item(tmp_path):
    x, y, w, b = _classifier_data(17)
    m = _port_classifier(w, b)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        m.summary()
    for kw, item in (({"zero": 1}, 4),
                     ({"grad_comm": "int8"}, 4), ({"prefetch": True}, 5),
                     ({"analyze": "warn"}, 5)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            m.fit(TensorDataset([x, y]), verbose=0, **kw)
