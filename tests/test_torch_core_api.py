"""The rest of the core API against the JAX package's, on the CPU:
``device``, ``utils`` (``unique_name``, ``deprecated``, ``try_import``,
``require_version``, ``run_check``, ``dlpack``, ``download``),
``version``, ``sysconfig``, ``compat``, ``batch``, ``summary`` and
``flops``, ``Model.summary``, ``train_batch(update=False)`` and
``Optimizer.minimize(parameters=, no_grad_set=)``.

``summary`` gives the JAX package's ``total_params``/``trainable_params``
on LeNet and GPT-2-tiny. ``flops`` counts products: exactly the analytic
count (2 per multiply-add) on a Linear stack and on LeNet's convolutions
and Linears, and on GPT-2-tiny (its products, attention's over the whole
square); against the JAX count there (XLA's cost analysis, which also
counts elementwise work, softmax and LayerNorm) the port's is 0.958 of
it (2 x 16 tokens), held within [0.9, 1.0]. The accumulated gradients of
``train_batch(update=False)`` equal the summed eager gradients within
1e-6 (float32, the same sums); a step then takes the lr times their sum.
"""
import os
import re
import tarfile
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu import batch as jbatch_mod  # noqa: F401
from paddle_tpu import compat as jcompat
from paddle_tpu import device as jdevice
from paddle_tpu import utils as jutils
from paddle_tpu import version as jversion
from paddle_tpu_torch import compat, device, utils, version


# -- device ---------------------------------------------------------------------

def test_device_answers_as_the_jax_package_where_the_builds_agree():
    for name in ("is_compiled_with_ipu", "is_compiled_with_mlu",
                 "is_compiled_with_npu", "is_compiled_with_xpu",
                 "is_compiled_with_cinn", "get_all_custom_device_type",
                 "get_available_custom_device"):
        assert getattr(device, name)() == getattr(jdevice, name)(), name
    assert set(jdevice.__all__) <= set(device.__all__)
    for place in ("XPUPlace", "MLUPlace", "IPUPlace"):
        for mod in (device, jdevice):
            with pytest.raises(RuntimeError, match=place[:3]):
                getattr(mod, place)(0)
    assert device.get_device() == pt.get_device()
    assert sorted(set(dir(jdevice.cuda)) - set(dir(device.cuda))) == []


def test_device_answers_are_this_builds():
    card = torch.cuda.is_available()
    assert device.is_compiled_with_cuda() == (torch.version.cuda is not None)
    assert device.is_compiled_with_rocm() == (torch.version.hip is not None)
    assert device.device_count() == torch.cuda.device_count()
    assert device.get_all_device_type() == (["cpu", "gpu"] if card
                                            else ["cpu"])
    cudnn = torch.backends.cudnn.version() \
        if torch.backends.cudnn.is_available() else None
    assert device.get_cudnn_version() == cudnn
    if not card:
        assert device.get_available_device() == ["cpu:0"]
        assert device.memory_allocated() == device.max_memory_allocated() \
            == device.memory_reserved() == 0
        assert device.memory_stats() == {} and jdevice.memory_stats() == {}
        assert "no memory statistics" in device.memory_summary()
        assert "no memory statistics" in jdevice.memory_summary()
        assert device.get_device_properties().platform == "cpu"
        device.synchronize()
        device.cuda.empty_cache()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device.memory_allocated("gpu:0")


def test_places_the_build_lacks_raise():
    for name in ("NPUPlace", "TPUPlace"):
        with pytest.raises(RuntimeError, match=name[:3]):
            getattr(pt, name)(0)
    assert isinstance(pt.device, type(os)) and pt.autograd.grad is pt.grad


# -- utils ----------------------------------------------------------------------

def test_unique_name_follows_the_jax_generator():
    def names(mod):
        out = [mod.generate("fc"), mod.generate("fc"), mod.generate("w")]
        with mod.guard():
            out += [mod.generate("fc"), mod.generate("fc")]
        out.append(mod.generate("fc"))
        old = mod.switch()
        out.append(mod.generate("fc"))
        mod.switch(old)
        out.append(mod.generate("w"))
        return out

    import threading
    got, want = [], []
    # a fresh thread each: the generators are thread-local
    for mod, out in ((utils.unique_name, got), (jutils.unique_name, want)):
        t = threading.Thread(target=lambda m=mod, o=out: o.extend(names(m)))
        t.start()
        t.join()
    assert got == want == ["fc_0", "fc_1", "w_0", "fc_0", "fc_1", "fc_2",
                           "fc_0", "w_1"]


def test_deprecated_try_import_require_version():
    msgs = []
    for mod in (utils, jutils):
        @mod.deprecated(update_to="new_fn", since="2.0", reason="renamed")
        def old_fn(x):
            return x + 1

        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert old_fn(1) == 2
        msgs.append(re.sub(r"API \S+ is", "API f is",
                           str(w[0].message)))
        assert w[0].category is DeprecationWarning
        assert mod.try_import("json").dumps(1) == "1"
        with pytest.raises(ImportError, match="needed here"):
            mod.try_import("no_such_module_anywhere", "needed here")
        mod.require_version("2.0", "2.9")
        with pytest.raises(Exception, match="required"):
            mod.require_version("9.0")
        with pytest.raises(Exception, match="allowed"):
            mod.require_version("1.0", "2.2")
    assert msgs[0] == msgs[1]
    assert utils.monitor is pt.framework.monitor
    assert utils.profiler is pt.profiler
    assert utils.pretrained.load_pdparams is pt.framework.io.load_pdparams


def test_run_check_trains_a_step(capsys):
    utils.run_check(device="cpu")
    assert "installed successfully" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            utils.run_check()


def test_dlpack_is_zero_copy_and_reads_the_jax_arrays():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    back = utils.dlpack.from_dlpack(utils.dlpack.to_dlpack(t))
    assert back.data_ptr() == t.data_ptr() and torch.equal(back, t)
    j = paddle.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    got = utils.dlpack.from_dlpack(jutils.dlpack.to_dlpack(j))
    np.testing.assert_array_equal(got.numpy(), j.numpy())
    assert torch.equal(utils.dlpack.from_dlpack(np.ones(3)),
                       torch.ones(3, dtype=torch.float64))


def test_download_resolves_local_files_only(tmp_path):
    url = "https://example.invalid/data/a.bin"
    for mod in (utils.download, jutils.download):
        with pytest.raises(RuntimeError, match="no network"):
            mod.get_path_from_url(url, str(tmp_path))
    (tmp_path / "a.bin").write_bytes(b"abc")
    md5 = "900150983cd24fb0d6963f7d28e17f72"
    for mod in (utils.download, jutils.download):
        assert mod.get_path_from_url(url, str(tmp_path), md5) == \
            str(tmp_path / "a.bin")
        with pytest.raises(RuntimeError, match="md5"):
            mod.get_path_from_url(url, str(tmp_path), "0" * 32)
    src = tmp_path / "pkg"
    src.mkdir()
    (src / "f.txt").write_text("x")
    with tarfile.open(tmp_path / "pkg.tar.gz", "w:gz") as t:
        t.add(src, arcname="pkg")
    (src / "f.txt").unlink()
    src.rmdir()
    got = utils.download.get_path_from_url(
        "https://example.invalid/pkg.tar.gz", str(tmp_path))
    assert got == str(tmp_path / "pkg")
    assert (tmp_path / "pkg" / "f.txt").read_text() == "x"
    assert utils.download.get_path_from_url(
        "https://example.invalid/pkg.tar.gz", str(tmp_path)) == got


# -- version, sysconfig, compat, batch --------------------------------------------

def test_version_sysconfig():
    for k in ("major", "minor", "patch", "rc"):
        assert getattr(version, k) == getattr(jversion, k), k
    assert version.full_version.startswith(jversion.full_version[:5])
    assert version.cuda() == (torch.version.cuda or "False")
    assert version.cudnn() == version.cudnn_version
    if not torch.backends.cudnn.is_available():
        assert version.cudnn() == "False"
    assert pt.version is version and pt.sysconfig.get_include().endswith(
        "csrc")
    assert os.path.exists(os.path.join(pt.sysconfig.get_include(),
                                       "layer_norm.cu"))
    from paddle_tpu_torch.ops._build import build_dir
    assert pt.sysconfig.get_lib() == str(build_dir())


@pytest.mark.parametrize("args", [(b"abc",), (["x", b"y"],), ({b"k": "v"},),
                                  (None,), (3,)])
def test_compat_text_and_bytes(args):
    assert compat.to_text(*args) == jcompat.to_text(*args)
    if args[0] != 3:
        assert compat.to_bytes(*args) == jcompat.to_bytes(*args)


def test_compat_numbers():
    for x, d in ((2.5, 0), (-2.5, 0), (1.005, 2), (None, 0)):
        assert compat.round(x, d) == jcompat.round(x, d)
    assert compat.floor_division(7, 2) == jcompat.floor_division(7, 2) == 3
    assert compat.get_exception_message(ValueError("m")) == "m"
    assert compat.long_type is int


@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_wraps_a_reader_as_the_jax_one(drop_last):
    def reader():
        yield from range(7)

    got = list(pt.batch(reader, 3, drop_last=drop_last)())
    want = list(paddle.batch(reader, 3, drop_last=drop_last)())
    assert got == want
    with pytest.raises(ValueError):
        pt.batch(reader, 0)


# -- summary / flops ------------------------------------------------------------

def _lenet_pair():
    from paddle_tpu.vision.models import LeNet as JaxLeNet
    from paddle_tpu_torch.vision.models import LeNet
    paddle.seed(0)
    pt.seed(0)
    return JaxLeNet(), LeNet()


def test_summary_counts_as_the_jax_one_on_lenet(capsys):
    jnet, tnet = _lenet_pair()
    want = paddle.summary(jnet, (1, 1, 28, 28))
    got = pt.summary(tnet, (1, 1, 28, 28))
    assert got == want
    table = capsys.readouterr().out
    assert "Conv2D" in table and "Total params: 61,610" in table
    for p, q in zip(tnet.parameters(), jnet.parameters()):
        p.requires_grad_(False)
        q.stop_gradient = True
        break
    assert pt.summary(tnet, input=torch.zeros(2, 1, 28, 28)) == \
        paddle.summary(jnet, (2, 1, 28, 28))


def test_summary_counts_as_the_jax_one_on_gpt_tiny():
    from paddle_tpu.models import GPTConfig as JaxGPTConfig
    from paddle_tpu.models import GPTForPretraining as JaxGPT
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    paddle.seed(0)
    pt.seed(0)
    jnet, tnet = JaxGPT(JaxGPTConfig.tiny()), GPTForPretraining(
        GPTConfig.tiny())
    ids = np.zeros((2, 16), np.int64)
    want = paddle.summary(jnet, input=[paddle.to_tensor(ids)])
    assert pt.summary(tnet, input=[torch.from_numpy(ids)]) == want


def test_model_summary():
    from paddle_tpu_torch.hapi import Model
    _, tnet = _lenet_pair()
    model = Model(tnet, device="cpu")
    total = sum(p.numel() for p in tnet.parameters())
    assert model.summary() == {"total_params": total,
                               "trainable_params": total}
    assert model.summary((1, 1, 28, 28))["total_params"] == total


def test_flops_of_a_linear_stack_is_the_analytic_count():
    net = torch.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.ReLU(),
                              pt.nn.Linear(16, 4))
    assert pt.flops(net, [3, 8]) == 2 * 3 * (8 * 16 + 16 * 4)
    x = torch.ones(5, 8)
    assert pt.flops(net, inputs=x) == 2 * 5 * (8 * 16 + 16 * 4)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        pt.flops(net, [3, 8], custom_ops={torch.nn.ReLU: None})


def test_flops_of_lenet_is_the_analytic_count():
    _, tnet = _lenet_pair()
    b = 2
    # LeNet: conv 1->6 3x3 pad 1 at 28x28, pool, conv 6->16 5x5 at 14 -> 10,
    # pool, Linear 400->120->84->10
    want = 2 * b * (28 * 28 * 6 * 1 * 9 + 10 * 10 * 16 * 6 * 25
                    + 400 * 120 + 120 * 84 + 84 * 10)
    assert pt.flops(tnet, [b, 1, 28, 28]) == want


def test_flops_of_gpt_tiny_against_the_jax_count():
    from paddle_tpu.models import GPTConfig as JaxGPTConfig
    from paddle_tpu.models import GPTForPretraining as JaxGPT
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    paddle.seed(0)
    pt.seed(0)
    jnet = JaxGPT(JaxGPTConfig.tiny())
    tnet = GPTForPretraining(GPTConfig.tiny())
    ids = np.random.RandomState(0).randint(0, 100, (2, 16))
    want = paddle.flops(jnet, inputs=[paddle.to_tensor(ids)])
    got = pt.flops(tnet, inputs=[torch.from_numpy(ids)])
    cfg = GPTConfig.tiny()
    b, t, d, h = 2, 16, cfg.hidden_size, cfg.num_attention_heads
    per_layer = 2 * b * t * (4 * d * d + 2 * d * cfg.intermediate_size) \
        + 4 * b * t * t * d
    head = 2 * b * t * d * cfg.vocab_size
    assert got == cfg.num_hidden_layers * per_layer + head
    assert 0.9 * want <= got <= want, (got, want)


# -- train_batch(update=False), minimize subsets -----------------------------------

def _linear_model(lr=0.5):
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import SGD
    pt.seed(1)
    net = pt.nn.Linear(4, 3)
    model = Model(net, device="cpu")
    model.prepare(SGD(lr, parameters=net.parameters()),
                  loss=lambda out, y: ((out - y) ** 2).mean())
    return model, net


def _data(seed, rows=6):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, 4).astype(np.float32),
            rng.randn(rows, 3).astype(np.float32))


def test_train_batch_without_update_accumulates_then_steps():
    model, net = _linear_model()
    start = [p.detach().clone() for p in net.parameters()]
    batches = [_data(s) for s in (1, 2, 3)]
    eager = []
    for x, y in batches:
        net.zero_grad()
        ((net(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean() \
            .backward()
        eager.append([p.grad.clone() for p in net.parameters()])
    net.zero_grad(set_to_none=True)
    for x, y in batches[:2]:
        loss = model.train_batch([x], [y], update=False)
        assert np.isfinite(loss)
    for p, a, b, p0 in zip(net.parameters(), *eager[:2], start):
        torch.testing.assert_close(p.grad, a + b, atol=1e-6, rtol=0)
        assert torch.equal(p.detach(), p0)          # nothing stepped
    model.train_batch([batches[2][0]], [batches[2][1]])
    for p, a, b, c, p0 in zip(net.parameters(), *eager, start):
        torch.testing.assert_close(p.detach(), p0 - 0.5 * (a + b + c),
                                   atol=1e-6, rtol=0)
        assert p.grad is None


def test_static_train_batch_without_update_raises_its_item():
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import SGD
    old = pt.get_device()
    pt.set_device("cpu")
    pt.enable_static()
    try:
        net = pt.nn.Linear(4, 3)
        model = Model(net, inputs=[InputSpec([None, 4], "float32", "x")],
                      labels=[InputSpec([None, 3], "float32", "y")],
                      device="cpu")
        model.prepare(SGD(0.1, parameters=net.parameters()),
                      loss=lambda out, y: ((out - y) ** 2).mean())
        x, y = _data(4)
        w0 = net.weight.detach().clone()
        # static mode accumulates as eager mode does (the static
        # adapter's replay): no step, no error, a gradient kept
        model.train_batch([x], [y], update=False)
        assert torch.equal(net.weight.detach(), w0)
        assert net.weight.grad is not None
        model.train_batch([x], [y], update=True)
        assert not torch.equal(net.weight.detach(), w0)
        assert net.weight.grad is None
    finally:
        pt.disable_static()
        pt.set_device(old)


def test_minimize_steps_only_the_chosen_parameters():
    from paddle_tpu_torch.optimizer import SGD
    pt.seed(2)
    a, b, c = (torch.nn.Parameter(torch.randn(3)) for _ in range(3))

    def run(**kw):
        opt = SGD(1.0, parameters=[("pa", a), ("pb", b), ("pc", c)])
        before = [t.detach().clone() for t in (a, b, c)]
        assert opt.minimize((a * a + b * b + c * c).sum(),
                            startup_program=object(), **kw) == (None, None)
        assert all(t.grad is None for t in (a, b, c))
        return [not torch.equal(t.detach(), u)
                for t, u in zip((a, b, c), before)]

    assert run() == [True, True, True]
    assert run(parameters=[b]) == [False, True, False]
    assert run(parameters=[a, c], no_grad_set={c}) == [True, False, False]
    assert run(no_grad_set=["pa", "pb"]) == [False, False, True]
    free = SGD(1.0)
    before = b.detach().clone()
    free.minimize((b * b).sum(), parameters=[b])
    torch.testing.assert_close(b.detach(), before - 2.0 * before)
    assert b.grad is None
