"""GPT-2 training in the PyTorch port against the JAX package, on the CPU:
the same weights (carried across with ``paddle_tpu_torch.convert``) and
the same batches through both.

* Eager float32 loop ``loss.backward(); opt.step(); opt.clear_grad()``,
  five steps of AdamW, with the JAX package's Pallas kernels forced on
  (interpret mode): losses per step agree within 1e-5, and every trained
  parameter within ``lr / 10``. Adam's normalised step moves an element
  by up to ``lr`` whatever its gradient's size, so an element whose
  gradient is near the rounding floor may differ by a part of ``lr``.
  The attention key biases have a true gradient of zero (a constant per
  softmax row), so all of their steps are rounding noise: they agree
  within ``5 * lr``.
* ``Model.fit`` in both packages (the JAX one runs its jitted functional
  step), on the dense loss path: losses per step agree within 1e-5.
* bf16 AMP O2 through ``Model.fit``: losses within 2e-2 of the JAX
  package's (bf16 keeps 8 bits of mantissa, and the two round at other
  places), and falling on a repeated batch.
* The port's forward logits equal the model of ``__graft_entry__.entry()``
  on the same weights within 1e-4 (float32).
* ``Model`` runs on the card unless asked for the CPU; AMP takes levels
  O1 and O2 in bf16 and float16 and raises on the rest;
  ``fit(verbose=2)`` prints progress.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.flags import set_flags
from paddle_tpu.hapi import Model as JaxModel
from paddle_tpu.hapi.callbacks import Callback as JaxCallback
from paddle_tpu.io import TensorDataset as JaxTensorDataset
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.nn.layer.layers import get_params_tree
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import gpt_from_jax_params, gpt_to_numpy_params
from paddle_tpu_torch.hapi import Callback, Model
from paddle_tpu_torch.hapi.callbacks import ProgBarLogger
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.models import GPTConfig
from paddle_tpu_torch.optimizer import AdamW

LR = 1e-3
CHUNKS = 4


def _jax_model(seed, chunks=CHUNKS):
    paddle.seed(seed)
    model = JaxGPT(JaxGPTConfig.tiny(), lm_loss_chunks=chunks)
    params = {k: np.asarray(v) for k, v in get_params_tree(model).items()}
    return model, params


def _batches(seed, n, batch=2, seq=16):
    """Next-token batches as ``bench_gpt2`` builds them: labels are the
    ids shifted by one, the last position ignored."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, JaxGPTConfig.tiny().vocab_size,
                      (n * batch, seq)).astype(np.int64)
    labels = np.concatenate([ids[:, 1:], np.full((n * batch, 1), -100)], 1)
    return ids, labels


class _Forced:
    """The JAX package's Pallas kernels on, for the duration."""

    def __enter__(self):
        set_flags({"FLAGS_pallas_force": True})

    def __exit__(self, *exc):
        set_flags({"FLAGS_pallas_force": False})


def _port(params, chunks=CHUNKS):
    return gpt_from_jax_params(params, GPTConfig.tiny(), device="cpu",
                               lm_loss_chunks=chunks)


def test_eager_float32_steps_match_jax():
    jmodel, params = _jax_model(0)
    ids, labels = _batches(1, 5)
    jopt = JaxAdamW(LR, parameters=jmodel.parameters(), weight_decay=0.01)
    want = []
    with _Forced():
        for i in range(5):
            loss, _ = jmodel(paddle.to_tensor(ids[2 * i:2 * i + 2]),
                             paddle.to_tensor(labels[2 * i:2 * i + 2]))
            loss.backward()
            jopt.step()
            jopt.clear_grad()
            want.append(float(loss))
    net = _port(params)
    opt = AdamW(LR, parameters=net.parameters(), weight_decay=0.01)
    got = []
    for i in range(5):
        loss, logits = net(torch.from_numpy(ids[2 * i:2 * i + 2]),
                           torch.from_numpy(labels[2 * i:2 * i + 2]))
        assert logits is None
        loss.backward()
        opt.step()
        opt.clear_grad()
        got.append(loss.item())
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    trained = {k: np.asarray(v) for k, v in get_params_tree(jmodel).items()}
    for key, arr in gpt_to_numpy_params(net).items():
        atol = 5 * LR if key.endswith("k_proj.bias") else LR / 10
        np.testing.assert_allclose(arr, trained[key], atol=atol, rtol=0,
                                   err_msg=key)


class _Losses:
    """The loss of every step, read from ``on_train_batch_end``."""

    def __init__(self):
        self.seen = []

    def on_train_batch_end(self, step, logs=None):
        self.seen.append(logs["loss"])


class _JaxLosses(_Losses, JaxCallback):
    pass


class _PortLosses(_Losses, Callback):
    pass


def _fit_both(amp_configs, ids, labels, epochs=1):
    """Both packages' ``fit`` on the dense loss path: the JAX ``fit``
    takes only tensor outputs, and the chunked loss returns ``None`` for
    the logits."""
    jmodel, params = _jax_model(2, chunks=1)
    jcb = _JaxLosses()
    jm = JaxModel(jmodel, inputs=["ids", "labels"])
    jm.prepare(JaxAdamW(LR, parameters=jmodel.parameters(),
                        weight_decay=0.01,
                        multi_precision=amp_configs is not None),
               loss=lambda loss, logits: loss, amp_configs=amp_configs)
    with _Forced():
        jm.fit(JaxTensorDataset([ids, labels]), batch_size=2,
               epochs=epochs, shuffle=False, log_freq=1, verbose=0,
               callbacks=[jcb])
    net = _port(params, chunks=1)
    cb = _PortLosses()
    model = Model(net, inputs=["ids", "labels"], device="cpu")
    model.prepare(AdamW(LR, parameters=net.parameters(), weight_decay=0.01,
                        multi_precision=amp_configs is not None),
                  loss=lambda loss, logits: loss, amp_configs=amp_configs)
    model.fit(TensorDataset([ids, labels]), batch_size=2, epochs=epochs,
              shuffle=False, log_freq=1, verbose=0, callbacks=[cb])
    return net, cb.seen, jcb.seen


def test_fit_float32_matches_jax_fit():
    ids, labels = _batches(3, 4)
    _, got, want = _fit_both(None, ids, labels)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_fit_bf16_o2_tracks_jax_and_falls_on_a_repeated_batch():
    ids, labels = _batches(4, 1)
    net, got, want = _fit_both({"level": "O2", "dtype": "bfloat16"},
                               ids, labels, epochs=4)
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    assert got[-1] < got[0] - 0.05


def test_train_batch_and_dense_loss_path():
    """``train_batch`` steps once; the dense path (``lm_loss_chunks=1``)
    returns the logits beside a loss equal to the chunked one, and an
    indivisible length raises."""
    _, params = _jax_model(5)
    ids, labels = _batches(6, 1)
    dense = gpt_from_jax_params(params, GPTConfig.tiny(), device="cpu")
    loss_d, logits = dense(torch.from_numpy(ids), torch.from_numpy(labels))
    assert tuple(logits.shape) == (2, 16, GPTConfig.tiny().vocab_size)
    chunked = _port(params)
    model = Model(chunked, inputs=["ids", "labels"], device="cpu")
    model.prepare(AdamW(LR, parameters=chunked.parameters()),
                  loss=lambda loss, logits: loss)
    first = model.train_batch([ids, labels])
    np.testing.assert_allclose(first, loss_d.item(), atol=1e-5, rtol=0)
    assert model.train_batch([ids, labels]) < first
    with pytest.raises(ValueError, match="not divisible"):
        chunked(torch.from_numpy(ids[:, :15]), torch.from_numpy(labels[:, :15]))


def test_forward_matches_graft_entry():
    import __graft_entry__
    fn, (params, ids) = __graft_entry__.entry()
    want = np.asarray(fn(params, ids))
    cfg = GPTConfig(vocab_size=8192, hidden_size=256, num_hidden_layers=4,
                    num_attention_heads=8, intermediate_size=1024,
                    max_position_embeddings=256, hidden_dropout_prob=0.0,
                    attention_dropout_prob=0.0)
    net = gpt_from_jax_params({k: np.asarray(v) for k, v in params.items()},
                              cfg, device="cpu").eval()
    with torch.no_grad():
        got = net(torch.from_numpy(np.asarray(ids, np.int64))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_o2_dtypes_follow_the_amp_policy():
    """Under O2 the residual stream is bf16 and every LayerNorm returns
    f32 (``amp_cast_inputs``)."""
    _, params = _jax_model(7)
    net = amp.decorate(_port(params), level="O2")
    seen = {}
    net.gpt.blocks[0].ln_1.register_forward_hook(
        lambda m, args, out: seen.update(ln_in=args[0].dtype, ln_out=out.dtype))
    net.gpt.blocks[0].attn.out_proj.register_forward_hook(
        lambda m, args, out: seen.update(proj=out.dtype))
    ids, labels = _batches(8, 1)
    with amp.auto_cast(level="O2"):
        loss, _ = net(torch.from_numpy(ids), torch.from_numpy(labels))
    assert seen == {"ln_in": torch.bfloat16, "ln_out": torch.float32,
                    "proj": torch.bfloat16}
    assert loss.dtype == torch.float32 and torch.isfinite(loss)


def _linear_model():
    torch.manual_seed(0)
    net = torch.nn.Linear(4, 1)
    model = Model(net, device="cpu")
    model.prepare(AdamW(LR, parameters=net.parameters()),
                  loss=lambda out, y: ((out - y) ** 2).mean())
    return net, model


def test_model_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(torch.nn.Linear(4, 1))
    _, model = _linear_model()
    assert model.device == torch.device("cpu")
    assert next(model.parameters()).is_cpu


def test_amp_takes_o2_bf16_and_raises_on_the_rest():
    """O1 and float16 run (the name is the test's, from when only O2 bf16
    did); an unknown level or dtype raises."""
    net = torch.nn.Linear(4, 4)
    for kw in ({"level": "O3"}, {"dtype": "int8"}):
        with pytest.raises(ValueError, match="AMP"):
            with amp.auto_cast(**kw):
                pass
        with pytest.raises(ValueError, match="AMP"):
            amp.decorate(net, **kw)
        with pytest.raises(ValueError, match="AMP"):
            Model(net, device="cpu").prepare(
                AdamW(LR, parameters=net.parameters()), loss=lambda o: o,
                amp_configs=kw)
    model = Model(net, device="cpu").prepare(
        AdamW(LR, parameters=net.parameters()), loss=lambda o: o,
        amp_configs={"dtype": "bfloat16"})            # the level is O1
    assert net.weight.dtype == torch.float32           # O1 casts no weight
    assert (model._amp_level, model._amp_dtype) == ("O1", "bfloat16")
    x = torch.ones(2, 4)
    for level, dtype, want in (("O1", "bfloat16", torch.bfloat16),
                               ("O1", "float16", torch.float16),
                               ("O2", "float16", torch.float16)):
        with amp.auto_cast(level=level, dtype=dtype):
            assert amp.cast_inputs("linear", x)[0].dtype == want
            assert amp.cast_inputs("layer_norm", x.to(want))[0].dtype == \
                torch.float32
            # off the lists: as given at O1, the AMP dtype at O2
            assert amp.cast_inputs("gelu", x)[0].dtype == (
                torch.float32 if level == "O1" else want)
            with amp.auto_cast(enable=False):
                assert amp.cast_inputs("linear", x)[0] is x
    assert amp.cast_inputs("linear", x)[0] is x
    half = amp.decorate(torch.nn.Linear(4, 4), level="O2", dtype="float16")
    assert half.weight.dtype == torch.float16


def test_grad_scaler_passes_the_loss_through():
    """``GradScaler(enable=False)`` passes the loss and the step through
    (``GradScaler()`` scales now, as in the JAX package)."""
    net, model = _linear_model()
    before = net.weight.detach().clone()
    scaler = amp.GradScaler(enable=False)
    loss = (net(torch.ones(2, 4)) ** 2).mean()
    assert scaler.scale(loss) is loss
    scaler.minimize(model._optimizer, loss)
    assert not torch.equal(net.weight, before)
    assert amp.GradScaler().scale(loss) is not loss


def test_fit_verbose_prints_progress(capsys):
    _, model = _linear_model()
    data = TensorDataset([np.ones((4, 4), np.float32),
                          np.zeros((4, 1), np.float32)])
    model.fit(data, batch_size=2, epochs=1, shuffle=False, log_freq=1,
              verbose=2)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Epoch 1/1"
    assert [line.split(" - ")[0] for line in out[1:3]] == ["step 0/2",
                                                            "step 1/2"]
    assert out[3].startswith("Epoch 1 done in") and "loss: " in out[3]
    model.fit(data, batch_size=2, verbose=0,
              callbacks=[ProgBarLogger(verbose=1)])
    assert len(capsys.readouterr().out.splitlines()) == 2
