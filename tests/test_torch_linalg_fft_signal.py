"""``linalg``, ``fft`` and ``signal`` of the PyTorch port against the JAX
package's, on the CPU (float32 inputs from a seeded RandomState).

Values are held within ``TOL`` (1e-4) of each result's largest magnitude
(LAPACK and XLA sum in other orders); the results defined only up to a
sign or a phase (``svd``, ``qr``, ``eig``, ``eigh``) are held by their
reconstructions and by their sorted values, never by raw vectors. ``lu``
is compared as ``P @ L @ U`` after ``lu_unpack``, with 1-based pivots on
both sides; a gradient through ``svd`` (the sum of the singular values)
is held as the JAX test holds it. ``hfftn``/``ihfftn`` follow the JAX
package's scipy alignment rule (``s`` without ``axes`` transforms the
last ``len(s)`` axes). ``stft``/``istft`` are the JAX bodies (reflect
padding, the window centre-padded to ``n_fft``, the ``win * win``
envelope clamped at 1e-11), including the round trip.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch import fft as tfft, linalg as tl, signal as tsig

TOL = 1e-4


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _mats(seed=0, n=5, batch=(3,)):
    rs = np.random.RandomState(seed)
    a = rs.randn(*batch, n, n).astype(np.float32)
    spd = (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(np.float32)
    return a, spd, rs.randn(*batch, n, 2).astype(np.float32)


def _pair(fn_name, *arrays, **kw):
    jout = getattr(paddle.linalg, fn_name)(
        *[paddle.to_tensor(a) for a in arrays], **kw)
    tout = getattr(tl, fn_name)(*[torch.tensor(a) for a in arrays], **kw)
    return jout, tout


@pytest.mark.parametrize("name, args", [
    ("det", "a"), ("inv", "spd"), ("cholesky", "spd"), ("matrix_rank", "a"),
    ("eigvalsh", "spd"), ("cond", "spd"), ("pinv", "a")])
def test_linalg_unary_matches_jax(name, args):
    a, spd, _ = _mats()
    x = {"a": a, "spd": spd}[args]
    jout, tout = _pair(name, x)
    _close(tout, jout)


def test_linalg_solves_and_norms_match_jax():
    a, spd, b = _mats(1)
    for name, arrays, kw in (
            ("solve", (spd, b), {}), ("cholesky", (spd,), {"upper": True}),
            ("triangular_solve", (np.triu(spd), b), {"upper": True}),
            ("matrix_power", (a,), {"n": 3}),
            ("norm", (a,), {}), ("norm", (a,), {"p": "nuc"}),
            ("norm", (a[0, 0],), {"p": 3.0, "axis": 0}),
            ("multi_dot", None, {})):
        if name == "multi_dot":
            want = paddle.linalg.multi_dot([paddle.to_tensor(m)
                                            for m in (a[0], a[1], a[2])])
            got = tl.multi_dot([torch.tensor(m) for m in (a[0], a[1], a[2])])
        else:
            want, got = _pair(name, *arrays, **kw)
        _close(got, want)
    (js, jl), (ts, tl_) = _pair("slogdet", spd)
    _close(ts, js)
    _close(tl_, jl)
    over = np.random.RandomState(2).randn(8, 3).astype(np.float32)
    rhs = np.random.RandomState(3).randn(8, 2).astype(np.float32)
    jx, tx = _pair("lstsq", over, rhs)
    _close(tx[0], jx[0])
    chol = np.linalg.cholesky(spd[0]).astype(np.float32)
    want = paddle.linalg.cholesky_solve(paddle.to_tensor(b[0]),
                                        paddle.to_tensor(chol))
    _close(tl.cholesky_solve(torch.tensor(b[0]), torch.tensor(chol)), want)


def test_decompositions_by_reconstruction():
    a, spd, _ = _mats(4, n=6)
    t = torch.tensor(a)
    u, s, vh = tl.svd(t)
    _close(u @ torch.diag_embed(s) @ vh, a)
    _close(torch.sort(s, -1).values,
           np.sort(_np(paddle.linalg.svd(paddle.to_tensor(a))[1]), -1))
    q, r = tl.qr(t)
    _close(q @ r, a)
    _close(q.mT @ q, np.broadcast_to(np.eye(6, dtype=np.float32), a.shape))
    w, v = tl.eigh(torch.tensor(spd))
    _close(v @ torch.diag_embed(w) @ v.mT, spd)
    _close(w, _np(paddle.linalg.eigh(paddle.to_tensor(spd))[0]))
    w, v = tl.eig(torch.tensor(a[0]))
    _close((torch.tensor(a[0]).to(v.dtype) @ v).abs(), (v * w).abs())
    want = _np(paddle.linalg.eigvals(paddle.to_tensor(a[0])))
    key = lambda z: np.lexsort((np.round(z.imag, 4), np.round(z.real, 4)))
    got = _np(tl.eigvals(torch.tensor(a[0])))
    _close(np.abs(got[key(got)]), np.abs(want[key(want)]))


def test_lu_and_unpack_match_jax():
    a, _, _ = _mats(5)
    jlu, jpiv, jinfo = paddle.linalg.lu(paddle.to_tensor(a), get_infos=True)
    tlu, tpiv, tinfo = tl.lu(torch.tensor(a), get_infos=True)
    assert np.array_equal(_np(tpiv), _np(jpiv)) and _np(tpiv).min() >= 1
    assert not _np(tinfo).any() and _np(tinfo).shape == _np(jinfo).shape
    _close(tlu, jlu)
    jp, jl, ju = paddle.linalg.lu_unpack(jlu, jpiv)
    tp, tl_, tu = tl.lu_unpack(tlu, tpiv)
    for g, w in ((tp, jp), (tl_, jl), (tu, ju)):
        _close(g, w)
    _close(tp @ tl_ @ tu, a)
    p, l_, u = tl.lu_unpack(tlu, tpiv, unpack_ludata=False)
    assert l_ is None and u is None and p is not None


def test_cov_corrcoef_and_svd_gradient_match_jax():
    rs = np.random.RandomState(6)
    x = rs.randn(3, 7).astype(np.float32)
    fw = rs.randint(1, 4, 7)
    aw = rs.rand(7).astype(np.float32)
    for kw in ({}, {"rowvar": False}, {"ddof": False}):
        _close(tl.cov(torch.tensor(x), **kw),
               paddle.linalg.cov(paddle.to_tensor(x), **kw))
    _close(tl.cov(torch.tensor(x), fweights=torch.tensor(fw),
                  aweights=torch.tensor(aw)),
           paddle.linalg.cov(paddle.to_tensor(x), fweights=fw, aweights=aw))
    _close(tl.corrcoef(torch.tensor(x)),
           paddle.linalg.corrcoef(paddle.to_tensor(x)))
    a = rs.randn(4, 6).astype(np.float32)
    ja = paddle.to_tensor(a, stop_gradient=False)
    paddle.linalg.svd(ja)[1].sum().backward()
    ta = torch.tensor(a, requires_grad=True)
    tl.svd(ta)[1].sum().backward()
    _close(ta.grad, ja.grad)


def _x(shape, seed=7, complex_=False):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    if complex_:
        x = (x + 1j * rs.randn(*shape)).astype(np.complex64)
    return x


@pytest.mark.parametrize("name, kw, cplx", [
    ("fft", {}, True), ("ifft", {"n": 10, "norm": "ortho"}, True),
    ("rfft", {"axis": 1}, False), ("irfft", {"n": 12}, True),
    ("hfft", {}, True), ("ihfft", {"norm": "forward"}, False),
    ("fft2", {}, True), ("ifft2", {"s": (4, 6)}, True),
    ("rfft2", {}, False), ("irfft2", {"s": (4, 10)}, True),
    ("fftn", {"axes": (0, 2)}, True), ("ifftn", {}, True),
    ("rfftn", {"s": (5, 8)}, False), ("irfftn", {}, True),
    ("hfftn", {}, True), ("ihfftn", {}, False),
    ("hfftn", {"s": (4, 6)}, True), ("ihfftn", {"s": (3, 8)}, False),
    ("hfft2", {"axes": (-2, -1)}, True), ("ihfft2", {"axes": (0, 1)}, False),
    ("fftshift", {}, False), ("ifftshift", {"axes": (1,)}, False)])
def test_fft_matches_jax(name, kw, cplx):
    x = _x((3, 5, 8), complex_=cplx)
    want = getattr(paddle.fft, name)(paddle.to_tensor(x), **kw)
    got = getattr(tfft, name)(torch.tensor(x), **kw)
    _close(got, want)


@pytest.mark.parametrize("name, cplx", [("hfft2", True), ("ihfft2", False)])
def test_2d_hermitian_ffts_default_to_the_last_two_axes(name, cplx):
    """On a 2-D input the JAX default (every axis) is the last two; on a
    3-D one the port keeps to the last two (a JAX-package defect, ROADMAP
    Queue 3), as the explicit ``axes=(-2, -1)`` call does."""
    x = _x((5, 8), complex_=cplx)
    _close(getattr(tfft, name)(torch.tensor(x)),
           getattr(paddle.fft, name)(paddle.to_tensor(x)))
    x3 = _x((3, 5, 8), complex_=cplx)
    _close(getattr(tfft, name)(torch.tensor(x3)),
           getattr(paddle.fft, name)(paddle.to_tensor(x3), axes=(-2, -1)))


def test_fft_frequencies_match_jax():
    for n, d in ((8, 1.0), (9, 0.5)):
        for name in ("fftfreq", "rfftfreq"):
            got = getattr(tfft, name)(n, d)
            assert got.dtype == torch.float32
            _close(got, getattr(paddle.fft, name)(n, d))


def test_frame_and_overlap_add_match_jax():
    x = _x((2, 50))
    jf = paddle.signal.frame(paddle.to_tensor(x), 16, 5)
    tf = tsig.frame(torch.tensor(x), 16, 5)
    assert tuple(tf.shape) == (2, 16, 7)
    _close(tf, jf)
    _close(tsig.overlap_add(tf, 5),
           paddle.signal.overlap_add(jf, 5))
    with pytest.raises(NotImplementedError):
        tsig.frame(torch.tensor(x), 16, 5, axis=0)


@pytest.mark.parametrize("kw", [
    {"n_fft": 64, "hop_length": 16, "window": "hann"},
    {"n_fft": 64, "hop_length": 20, "win_length": 48, "window": "hann",
     "normalized": True},
    {"n_fft": 32, "center": False},
    {"n_fft": 32, "hop_length": 8, "onesided": False, "window": "hann",
     "pad_mode": "constant"}])
def test_stft_and_istft_round_trip_match_jax(kw):
    kw = dict(kw)
    x = _x((3, 400), seed=8)
    if kw.get("window") == "hann":
        win = np.hanning(kw.get("win_length", kw["n_fft"]) + 1)[:-1]
        kw["window"] = win.astype(np.float32)
    jkw = {k: (paddle.to_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jspec = paddle.signal.stft(paddle.to_tensor(x), **jkw)
    tspec = tsig.stft(torch.tensor(x), **tkw)
    _close(tspec, jspec)
    ikw = {k: v for k, v in tkw.items() if k != "pad_mode"}
    jikw = {k: v for k, v in jkw.items() if k != "pad_mode"}
    back = tsig.istft(tspec, length=400, **ikw)
    _close(back, paddle.signal.istft(jspec, length=400, **jikw))
    if kw.get("center", True) and kw.get("window") is not None:
        edge = kw["n_fft"]          # the envelope is thin at the ends
        _close(back[:, edge:-edge], x[:, edge:-edge])
    if kw.get("onesided", True):
        with pytest.raises(ValueError, match="onesided"):
            tsig.istft(tspec, return_complex=True, **ikw)
