"""AMP in the port against the JAX package, on the CPU: the O1/O2 cast
policy with custom lists, float16, the ``GradScaler`` state machine, a
float16 O2 eager loop of GPT-2-tiny, and the two defaults that used to
differ (``auto_cast()`` is level O1; ``GradScaler()`` is enabled at
2**15).

Tolerances: dtypes and the scaler's state are compared exactly. The
float16 loop's losses agree within 1e-3: the loss is a float32 mean over
float16 activations (11 bits), which the two packages round at other
places (the JAX package's plain attention accumulates in another order),
so an activation one f16 ulp apart moves it by far less than 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.tensor import Parameter as JaxParameter
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.nn.layer.layers import get_params_tree
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import gpt_from_jax_params
from paddle_tpu_torch.models import GPTConfig

NEITHER = "gelu"                 # on no list: cast at O2 only
_JDT = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}
_TDT = {"bfloat16": torch.bfloat16, "float16": torch.float16,
        "float32": torch.float32}
OPS = sorted(jamp.white_list | jamp.black_list) + [NEITHER]


def _jax_dtypes(op, dtypes, **kw):
    arrays = [jnp.zeros(2, jnp.dtype(d) if d != "bfloat16"
                        else jnp.bfloat16) for d in dtypes] + [jnp.zeros(
                            2, jnp.int32)]
    with jamp.auto_cast(**kw):
        out = jamp.amp_cast_inputs(op, arrays)
    return [str(jnp.dtype(a.dtype)) for a in out]


def _port_dtypes(op, dtypes, **kw):
    tensors = [torch.zeros(2, dtype=_TDT[d]) for d in dtypes] + [
        torch.zeros(2, dtype=torch.int32)]
    with amp.auto_cast(**kw):
        out = amp.cast_inputs(op, *tensors)
    return [str(t.dtype).removeprefix("torch.") for t in out]


INPUTS = ("float32", "bfloat16", "float16")


@pytest.mark.parametrize("op", OPS)
def test_bare_auto_cast_is_o1_as_in_jax(op):
    """The first repair: ``auto_cast()`` with no arguments is level O1 in
    bf16 (white list down, black list up, the rest as given)."""
    with amp.auto_cast():
        assert amp.get_amp_level() == "O1"
        assert amp.get_amp_dtype() == torch.bfloat16
    assert _port_dtypes(op, INPUTS) == _jax_dtypes(op, INPUTS)


def test_bare_grad_scaler_is_enabled_at_2_to_15_as_in_jax():
    """The second repair: ``GradScaler()`` scales, by 2**15."""
    assert amp.GradScaler().get_loss_scaling() == \
        jamp.GradScaler().get_loss_scaling() == 2. ** 15
    assert amp.GradScaler().is_enable() and \
        amp.GradScaler().is_use_dynamic_loss_scaling()
    loss = torch.tensor(0.5)
    assert float(amp.GradScaler().scale(loss)) == 0.5 * 2 ** 15


CUSTOM = [dict(),
          dict(custom_white_list={"layer_norm", NEITHER}),
          dict(custom_black_list={"linear", "matmul"}),
          dict(custom_white_list={"softmax"}, custom_black_list={"gelu"})]


@pytest.mark.parametrize("custom", range(len(CUSTOM)))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_cast_table_matches_jax(level, dtype, custom):
    kw = dict(CUSTOM[custom], level=level, dtype=dtype)
    for op in OPS:
        assert _port_dtypes(op, INPUTS, **kw) == \
            _jax_dtypes(op, INPUTS, **kw), op


def test_auto_cast_nests_and_disables():
    x = torch.ones(2)
    with amp.auto_cast(level="O2", dtype="float16"):
        assert amp.cast_inputs(NEITHER, x)[0].dtype == torch.float16
        with amp.auto_cast(enable=False):
            assert amp.cast_inputs("linear", x)[0] is x
            assert not amp.is_auto_cast_enabled()
        assert amp.get_amp_level() == "O2"
    assert amp.get_amp_level() == "O0" and amp.get_amp_dtype() is None
    assert amp.cast_inputs("linear", x)[0] is x
    assert "linear" in amp.white_list and "layer_norm" in amp.black_list


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_decorate_casts_to_float16_at_o2_only(level):
    net = torch.nn.Linear(4, 4)
    out, opt = amp.decorate(net, optimizers="opt", level=level,
                            dtype="float16")
    assert out is net and opt == "opt"
    want = torch.float16 if level == "O2" else torch.float32
    assert net.weight.dtype == want


# ----------------------------------------------------------- GradScaler
# per step: the gradient is finite (True) or poisoned with inf (False)
SEQUENCE = [True, True, False, True, False, False, True, True, True,
            False, True, True, True, True]


def _scaler_kw():
    return dict(init_loss_scaling=2. ** 10, incr_every_n_steps=3,
                decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5)


def test_grad_scaler_state_machine_matches_jax():
    """Scale, streaks, skipped steps and the parameters over a fixed
    finite/inf sequence; the state dict mid-run restores the streaks."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(6).astype(np.float32)
    jp = JaxParameter(jnp.asarray(w0), name="w")
    tp = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    jo = jopt.SGD(0.1, parameters=[jp])
    to = topt.SGD(0.1, parameters=[("w", tp)])
    js, ts = jamp.GradScaler(**_scaler_kw()), amp.GradScaler(**_scaler_kw())
    for i, finite in enumerate(SEQUENCE):
        g = rng.randn(6).astype(np.float32) * js.get_loss_scaling()
        if not finite:
            g[i % 6] = np.inf if i % 2 else np.nan
        jp.grad = paddle.to_tensor(g)
        tp.grad = torch.from_numpy(g.copy())
        js.step(jo)
        ts.step(to)
        assert ts.state() == js.state()             # the pending verdict
        js.update()
        ts.update()
        assert ts.state() == js.state()
        assert ts.state_dict() == js.state_dict()
        assert to._step_count == jo._step_count
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._data),
                                   atol=1e-6, rtol=1e-6)
        jo.clear_grad()
        to.clear_grad()
        if i == 6:
            restored = amp.GradScaler(**_scaler_kw())
            restored.load_state_dict(ts.state_dict())
            assert restored.state() == ts.state()
    assert to._step_count == sum(SEQUENCE)          # skipped steps
    assert ts.get_loss_scaling() != 2. ** 10


def test_grad_scaler_guards_its_order_and_passes_through_disabled():
    p = torch.nn.Parameter(torch.ones(2))
    opt = topt.SGD(0.5, parameters=[p])
    s = amp.GradScaler(init_loss_scaling=4.0)
    s.scale((p * 1.0).sum()).backward()
    s.unscale_(opt)
    assert torch.equal(p.grad, torch.ones(2))        # 4 / 4
    with pytest.raises(RuntimeError, match="once"):
        s.unscale_(opt)
    s.step(opt)
    with pytest.raises(RuntimeError, match="already"):
        s.step(opt)
    s.update()
    off = amp.GradScaler(enable=False)
    loss = (p * 2.0).sum()
    assert off.scale(loss) is loss and off.get_loss_scaling() == 1.0
    assert off.state()["enabled"] is False


# ---------------------------------------------------- float16 GPT loop
def test_float16_o2_eager_loop_matches_jax():
    """GPT-2-tiny, float16 O2, AdamW multi-precision under a GradScaler:
    ``scaler.scale(loss).backward(); scaler.step(opt); scaler.update()``,
    3 steps from the same weights in both packages: losses within 1e-3,
    the scale and the optimizer step equal, every parameter float16 and
    every master float32."""
    paddle.seed(11)
    jnet = JaxGPT(JaxGPTConfig.tiny(), lm_loss_chunks=1)
    params = {k: np.asarray(v) for k, v in get_params_tree(jnet).items()}
    net = gpt_from_jax_params(params, GPTConfig.tiny(), device="cpu")
    rng = np.random.RandomState(12)
    ids = rng.randint(0, JaxGPTConfig.tiny().vocab_size, (3, 2, 16))
    labels = np.concatenate([ids[..., 1:], np.full((3, 2, 1), -100)], -1)
    kw = dict(init_loss_scaling=2. ** 15, incr_every_n_steps=2)

    jamp.decorate(jnet, level="O2", dtype="float16")
    jo = jopt.AdamW(1e-3, parameters=jnet.parameters(), weight_decay=0.01,
                    multi_precision=True)
    js = jamp.GradScaler(**kw)
    want = []
    for i in range(3):
        with jamp.auto_cast(level="O2", dtype="float16"):
            loss, _ = jnet(paddle.to_tensor(ids[i]),
                           paddle.to_tensor(labels[i]))
        js.scale(loss).backward()
        js.step(jo)
        js.update()
        jo.clear_grad()
        want.append(float(loss))

    amp.decorate(net, level="O2", dtype="float16")
    to = topt.AdamW(1e-3, parameters=net.named_parameters(),
                    weight_decay=0.01, multi_precision=True)
    ts = amp.GradScaler(**kw)
    got = []
    for i in range(3):
        with amp.auto_cast(level="O2", dtype="float16"):
            loss, _ = net(torch.from_numpy(ids[i]),
                          torch.from_numpy(labels[i]))
        ts.scale(loss).backward()
        ts.step(to)
        ts.update()
        to.clear_grad()
        got.append(loss.item())
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert ts.state() == js.state() and to._step_count == jo._step_count
    assert all(p.dtype == torch.float16 for p in net.parameters())
    masters = [v for k, v in to.state_dict().items()
               if k.endswith("master_weight")]
    assert len(masters) == len(list(net.parameters()))
    assert all(m.dtype == torch.float32 for m in masters)
