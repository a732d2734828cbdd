"""The port's C inference API (``csrc/tpu_infer_capi.cc`` +
``inference/capi.py``), on the CPU.

Reference: paddle/fluid/inference/capi_exp/pd_inference_api.h, the C ABI
over the predictor for non-Python serving processes. ``g++`` builds the
library at first use (skipped where there is no ``g++``, as the JAX
suite's ``tests/test_infer_capi.py`` is); the test plays the C caller
through ctypes, with the symbols and buffers a C program would pass:
LeNet saved by ``jit.save`` (``bench_serve``'s spec), one batch run from
C equal to the Python ``Predictor``'s output bit for bit, and to the JAX
package's C API on the same weights within 1e-5 (float32). Creating a
predictor without a device runs on the card, so here it fails with the
"no CUDA device" message in ``PDT_LastError``; ``PDT_PredictorCreateOn(
prefix, "cpu")`` asks for the CPU.
"""
import ctypes
import os
import shutil

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.vision.models import LeNet as JLeNet
import paddle_tpu_torch as pt
from paddle_tpu_torch import inference, jit
from paddle_tpu_torch.convert import layer_from_jax
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.vision.models import LeNet

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture(scope="module")
def capi():
    from paddle_tpu_torch.inference.capi import load_capi
    lib, path = load_capi()
    assert path.startswith(os.path.join(REPO, "build"))
    assert lib.PDT_Init(REPO.encode()) == 0
    return lib


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    d = tmp_path_factory.mktemp("capi")
    paddle.seed(0)
    jnet = JLeNet()
    jnet.eval()
    tnet = LeNet().eval()
    layer_from_jax(tnet, jnet.state_dict())
    old = pt.get_device()
    pt.set_device("cpu")
    try:
        jit.save(tnet, str(d / "t"),
                 input_spec=[InputSpec([None, 1, 28, 28], "float32")])
    finally:
        pt.set_device(old)
    paddle.jit.save(jnet, str(d / "j"), input_spec=[
        paddle.static.InputSpec([None, 1, 28, 28], "float32")])
    return str(d / "t"), str(d / "j")


def _run(lib, handle, x):
    shape = (ctypes.c_int64 * x.ndim)(*x.shape)
    data = x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    out = ctypes.POINTER(ctypes.c_float)()
    out_shape = ctypes.POINTER(ctypes.c_int64)()
    out_ndim = ctypes.c_int()
    rc = lib.PDT_PredictorRun(handle, data, shape, x.ndim,
                              ctypes.byref(out), ctypes.byref(out_shape),
                              ctypes.byref(out_ndim))
    assert rc == 0, lib.PDT_LastError().decode()
    dims = [out_shape[i] for i in range(out_ndim.value)]
    n = int(np.prod(dims))
    result = np.ctypeslib.as_array(out, shape=(n,)).reshape(dims).copy()
    lib.PDT_BufferFree(out)
    lib.PDT_BufferFree(out_shape)
    return result


def test_run_from_c_equals_the_predictor_and_the_jax_capi(capi, artifact):
    prefix, jprefix = artifact
    h = capi.PDT_PredictorCreateOn(prefix.encode(), b"cpu")
    assert h, capi.PDT_LastError().decode()
    x = np.random.RandomState(0).randn(4, 1, 28, 28).astype("float32")
    got = _run(capi, h, x)
    cfg = inference.Config(prefix + ".pdmodel")
    cfg.disable_gpu()
    np.testing.assert_array_equal(got,
                                  inference.create_predictor(cfg).run([x])[0])
    np.testing.assert_array_equal(_run(capi, h, x), got)
    capi.PDT_PredictorDestroy(h)
    from paddle_tpu.inference.capi import load_capi as jax_capi
    jlib, _ = jax_capi()
    assert jlib.PDT_Init(None) == 0
    jh = jlib.PDT_PredictorCreate(jprefix.encode())
    assert jh, jlib.PDT_LastError().decode()
    want = _run(jlib, jh, x)
    jlib.PDT_PredictorDestroy(jh)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_the_default_device_is_the_card(capi, artifact):
    prefix, _ = artifact
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    assert not capi.PDT_PredictorCreate(prefix.encode())
    assert b"no CUDA device" in capi.PDT_LastError()


def test_missing_model_sets_error(capi):
    assert not capi.PDT_PredictorCreateOn(b"/nonexistent/model", b"cpu")
    assert capi.PDT_LastError()


def test_null_arguments_rejected(capi, artifact):
    prefix, _ = artifact
    h = capi.PDT_PredictorCreateOn(prefix.encode(), b"cpu")
    out = ctypes.POINTER(ctypes.c_float)()
    out_shape = ctypes.POINTER(ctypes.c_int64)()
    out_ndim = ctypes.c_int()
    rc = capi.PDT_PredictorRun(h, None, None, 0, ctypes.byref(out),
                               ctypes.byref(out_shape),
                               ctypes.byref(out_ndim))
    assert rc == -1
    assert b"null" in capi.PDT_LastError()
    assert not capi.PDT_PredictorCreateOn(None, b"cpu")
    capi.PDT_PredictorDestroy(h)
