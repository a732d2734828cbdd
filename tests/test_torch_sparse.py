"""``sparse`` and ``sparse.nn`` of the PyTorch port against the JAX
package's, on the CPU.

The same indices and values (a seeded RandomState) go into both
packages' COO/CSR tensors: creation (``shape`` from the indices too),
``to_dense``, ``coalesce``, the unary and binary ops (same pattern: a
COO result; other patterns: dense), ``matmul`` (COO and CSR; CSR goes
through COO, as in the JAX package) and ``masked_matmul``, ``cast``;
then ``conv3d`` (output sites: every site a window reaches from an
active one), ``subm_conv3d`` (the input's pattern), ``max_pool3d`` (only
active sites compete; a zero-valued active site stays a site; an empty
window gives none), ``batch_norm`` and the layers, forward and the
weights' gradients. Values within 1e-5 of each result's largest
magnitude; patterns equal exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import sparse as JS
from paddle_tpu.sparse import nn as jsnn
import paddle_tpu_torch as pt
from paddle_tpu_torch import sparse as TS
from paddle_tpu_torch.sparse import nn as tsnn

TOL = 1e-5


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    if hasattr(t, "_data"):
        return np.asarray(t._data)
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _coo(seed=0, shape=(5, 6), nnz=9, dup=True):
    rs = np.random.RandomState(seed)
    idx = np.stack([rs.randint(0, s, nnz) for s in shape])
    if dup:
        idx[:, -1] = idx[:, 0]             # one duplicated site
    vals = rs.randn(nnz).astype(np.float32)
    return idx, vals


def _pair(idx, vals, shape=None):
    return (JS.sparse_coo_tensor(idx, vals, shape),
            TS.sparse_coo_tensor(idx, vals, shape))


def test_creation_dense_and_coalesce_match_jax():
    idx, vals = _coo()
    for shape in ((5, 6), None):
        j, t = _pair(idx, vals, shape)
        assert t.shape == j.shape and t.nnz() == j.nnz() == 9
        assert t.is_sparse_coo() and TS.is_sparse(t)
        _close(t.to_dense(), j.to_dense())
        _close(t.indices(), j.indices())
        _close(t.values(), j.values())
    jc, tc = j.coalesce(), t.coalesce()
    assert tc.nnz() == jc.nnz() < t.nnz()
    assert np.array_equal(_np(tc.indices()), _np(jc.indices()))
    _close(tc.values(), jc.values())
    t64 = TS.sparse_coo_tensor(idx, vals, (5, 6), dtype="float64")
    assert t64.dtype == torch.float64
    crows = np.array([0, 2, 3, 3, 5])
    cols = np.array([0, 3, 1, 2, 4])
    cv = np.arange(1, 6, dtype=np.float32)
    jcsr = JS.sparse_csr_tensor(crows, cols, cv, (4, 5))
    tcsr = TS.sparse_csr_tensor(crows, cols, cv, (4, 5))
    assert tcsr.is_sparse_csr() and tcsr.nnz() == jcsr.nnz()
    _close(tcsr.to_dense(), jcsr.to_dense())
    _close(tcsr.crows(), jcsr.crows())
    _close(tcsr.cols(), jcsr.cols())


@pytest.mark.parametrize("name", ["relu", "sqrt", "sin", "tanh", "abs",
                                  "neg", "pow"])
def test_unary_ops_act_on_values(name):
    idx, vals = _coo(1)
    vals = np.abs(vals) if name == "sqrt" else vals
    j, t = _pair(idx, vals, (5, 6))
    args = (2,) if name == "pow" else ()
    jo, to = getattr(JS, name)(j, *args), getattr(TS, name)(t, *args)
    assert isinstance(to, TS.SparseCooTensor)
    _close(to.values(), jo.values())
    _close(to.to_dense(), jo.to_dense())
    dense = np.abs(vals[:4]) + 0.5
    _close(getattr(TS, name)(torch.tensor(dense), *args),
           getattr(JS, name)(paddle.to_tensor(dense), *args))


@pytest.mark.parametrize("name", ["add", "subtract", "multiply", "divide"])
def test_binary_ops_match_jax(name):
    idx, va = _coo(2, dup=False)
    _, vb = _coo(3, dup=False)
    vb = np.abs(vb) + 0.5
    ja, ta = _pair(idx, va, (5, 6))
    jb, tb = _pair(idx, vb, (5, 6))
    to, jo = getattr(TS, name)(ta, tb), getattr(JS, name)(ja, jb)
    assert isinstance(to, TS.SparseCooTensor)
    _close(to.to_dense(), jo.to_dense())
    idx2, vc = _coo(4, dup=False)
    jc, tc = _pair(idx2, np.abs(vc) + 0.5, (5, 6))
    dense = getattr(TS, name)(ta, tc)
    assert isinstance(dense, torch.Tensor)
    _close(dense, getattr(JS, name)(ja, jc))


def test_matmul_and_masked_matmul_match_jax():
    idx, vals = _coo(5, shape=(5, 6), nnz=12)
    j, t = _pair(idx, vals, (5, 6))
    b = np.random.RandomState(6).randn(6, 3).astype(np.float32)
    _close(TS.matmul(t, torch.tensor(b)), JS.matmul(j, paddle.to_tensor(b)))
    crows = np.array([0, 2, 3, 3, 5, 6])
    cols = np.array([0, 3, 1, 2, 4, 5])
    cv = np.arange(1, 7, dtype=np.float32)
    jcsr = JS.sparse_csr_tensor(crows, cols, cv, (5, 6))
    tcsr = TS.sparse_csr_tensor(crows, cols, cv, (5, 6))
    _close(TS.matmul(tcsr, torch.tensor(b)),
           JS.matmul(jcsr, paddle.to_tensor(b)))
    idx3, v3 = _coo(7, shape=(2, 5, 6), nnz=10, dup=False)
    j3, t3 = _pair(idx3, v3, (2, 5, 6))
    _close(TS.matmul(t3, torch.tensor(b)), JS.matmul(j3, paddle.to_tensor(b)))
    x = np.random.RandomState(8).randn(5, 4).astype(np.float32)
    y = np.random.RandomState(9).randn(4, 6).astype(np.float32)
    to = TS.masked_matmul(torch.tensor(x), torch.tensor(y), t)
    jo = JS.masked_matmul(paddle.to_tensor(x), paddle.to_tensor(y), j)
    assert np.array_equal(_np(to.indices()), _np(jo.indices()))
    _close(to.values(), jo.values())
    with pytest.raises(TypeError):
        TS.masked_matmul(torch.tensor(x), torch.tensor(y), tcsr)
    c = TS.cast(t, index_dtype="int32", value_dtype="float64")
    assert c.indices().dtype == torch.int32 and c.dtype == torch.float64


def _cloud(shape, density, seed, zero_site=False):
    rs = np.random.RandomState(seed)
    site = rs.rand(*shape[:-1]) < density
    dense = rs.randn(*shape).astype(np.float32) * site[..., None]
    idx = np.argwhere(site)
    vals = dense[tuple(idx.T)]
    if zero_site:
        vals[0] = 0.0
    return (JS.SparseCooTensor.from_parts(idx.T, vals, shape),
            TS.SparseCooTensor.from_parts(idx.T, vals, shape))


def _same(to, jo):
    assert to.shape == jo.shape
    assert np.array_equal(_np(to.indices()), _np(jo.indices()))
    _close(to.values(), jo.values())


@pytest.mark.parametrize("stride, padding", [(1, 1), (2, 0)])
def test_conv3d_matches_jax(stride, padding):
    j, t = _cloud((2, 6, 6, 6, 3), 0.15, 0, zero_site=True)
    rs = np.random.RandomState(1)
    w = rs.randn(3, 3, 3, 3, 8).astype(np.float32)
    b = rs.randn(8).astype(np.float32)
    jo = jsnn.conv3d(j, w, b, stride=stride, padding=padding)
    to = tsnn.conv3d(t, torch.tensor(w), torch.tensor(b), stride=stride,
                     padding=padding)
    _same(to, jo)


def test_subm_conv3d_keeps_the_pattern_and_trains():
    j, t = _cloud((2, 5, 5, 5, 4), 0.2, 2, zero_site=True)
    paddle.seed(3)
    jl = jsnn.SubmConv3D(4, 6, 3, padding=1)
    tl = tsnn.SubmConv3D(4, 6, 3, padding=1)
    with torch.no_grad():
        tl.weight.copy_(torch.tensor(_np(jl.weight)))
        tl.bias.copy_(torch.tensor(_np(jl.bias)))
    jo, to = jl(j), tl(t)
    _same(to, jo)
    assert np.array_equal(_np(to.indices()), _np(t.indices()))
    (jo.values() ** 2).sum().backward()
    (to.values() ** 2).sum().backward()
    _close(tl.weight.grad, jl.weight.grad)
    _close(tl.bias.grad, jl.bias.grad)
    with pytest.raises(ValueError, match="stride"):
        tsnn.subm_conv3d(t, tl.weight, stride=2, padding=1)
    with pytest.raises(ValueError, match="shape-preserving"):
        tsnn.subm_conv3d(t, tl.weight, padding=0)
    with pytest.raises(ValueError, match="NDHWC"):
        tsnn.conv3d(t, tl.weight, data_format="NCDHW")


@pytest.mark.parametrize("case", ["mixed", "negative", "zero", "empty"])
def test_max_pool3d_matches_jax(case):
    if case == "mixed":
        j, t = _cloud((2, 6, 6, 6, 3), 0.2, 4, zero_site=True)
        kw = {"kernel_size": 2}
    else:
        shape = (1, 4, 4, 4, 1)
        idx = np.array([[0, 0, 0, 0]]).T
        v = {"negative": -3.0, "zero": 0.0, "empty": 2.0}[case]
        vals = np.array([[v]], np.float32)
        j = JS.SparseCooTensor.from_parts(idx, vals, shape)
        t = TS.SparseCooTensor.from_parts(idx, vals, shape)
        kw = {"kernel_size": 2, "stride": 2}
    jo, to = jsnn.max_pool3d(j, **kw), tsnn.max_pool3d(t, **kw)
    _same(to, jo)
    if case != "mixed":
        assert to.nnz() == 1


def test_batch_norm_and_layers_match_jax():
    j, t = _cloud((2, 4, 4, 4, 3), 0.5, 12)
    jbn, tbn = jsnn.BatchNorm(3), tsnn.BatchNorm(3)
    for mode in ("train", "eval"):
        getattr(jbn, mode)()
        getattr(tbn, mode)()
        _same(tbn(t), jbn(j))
        _close(tbn._mean, jbn._mean)
        _close(tbn._variance, jbn._variance)
    _same(tsnn.ReLU()(t), jsnn.ReLU()(j))
    _same(tsnn.MaxPool3D(2, stride=2)(t), jsnn.MaxPool3D(2, stride=2)(j))
    m, v = np.float32([0.1, -0.2, 0.3]), np.float32([1.5, 0.5, 2.0])
    w, b = np.float32([1.0, 2.0, 0.5]), np.float32([0.0, 0.1, -0.1])
    _same(tsnn.batch_norm(t, m, v, w, b), jsnn.batch_norm(j, m, v, w, b))
    paddle.seed(5)
    jc = jsnn.Conv3D(3, 2, 2, stride=2, bias_attr=False)
    tc = tsnn.Conv3D(3, 2, 2, stride=2, bias_attr=False)
    assert tc.bias is None
    with torch.no_grad():
        tc.weight.copy_(torch.tensor(_np(jc.weight)))
    _same(tc(t), jc(j))
