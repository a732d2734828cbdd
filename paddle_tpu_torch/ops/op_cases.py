"""One small sample case for every op of the library, and how to judge it.

:func:`cases` gives, per registered op name, the inputs of one call (numpy
arrays and Python values, made from a seed) and the rule its result is
held to: ``"close"`` (floating values within a tolerance), ``"exact"``
(integers and booleans bit for bit, with the dtype), ``"random"`` (a
sampler: only its distribution is checked, by the case's ``stat``), or a
named structural check for a decomposition whose factors are unique only
up to signs (``qr``, ``svd``, ``eig``, ``eigh``). The parity tests hold
each op against the JAX package's on these inputs; ``chip_smoke.py``
holds each op on the card against the same op on the CPU.

An argument equal to :data:`KEY` is the random state: the JAX op's PRNG
key, the port's ``torch.Generator``. ``creation`` marks the ops that make
a tensor from nothing, which take ``device=`` in the port.
"""
from __future__ import annotations

import numpy as np

__all__ = ["KEY", "Case", "cases", "check", "to_numpy_tree"]

KEY = "<random state>"


class Case:
    __slots__ = ("name", "args", "attrs", "check", "creation", "stat", "tol")

    def __init__(self, name, args=(), attrs=None, check="close",
                 creation=False, stat=None, tol=None):
        self.name = name
        self.args = tuple(args)
        self.attrs = dict(attrs or {})
        self.check = check
        self.creation = creation
        self.stat = stat
        self.tol = tol


def to_numpy_tree(out):
    """An op's result (an array, or a tuple/list of them) as numpy."""
    if isinstance(out, (list, tuple)):
        return [to_numpy_tree(o) for o in out]
    if hasattr(out, "detach"):
        t = out.detach().cpu()
        if str(t.dtype) == "torch.bfloat16":
            t = t.float()
        return t.numpy()
    return np.asarray(out)


def _close(got, want, atol, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} vs " \
                                    f"{want.shape}"
    if want.dtype.kind in "iub":
        assert got.dtype == want.dtype, f"{what}: dtype {got.dtype} vs " \
                                        f"{want.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got.dtype.kind == want.dtype.kind, \
            f"{what}: dtype {got.dtype} vs {want.dtype}"
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                                   err_msg=what, equal_nan=True)


def _tree(got, want, atol, rtol, what):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), \
            f"{what}: {len(got)} outputs vs {len(want)}"
        for i, (g, w) in enumerate(zip(got, want)):
            _tree(g, w, atol, rtol, f"{what}[{i}]")
    else:
        _close(got, want, atol, rtol, what)


def _check_qr(args, got, want, atol):
    a = args[0]
    for q, r in (got, want):
        np.testing.assert_allclose(q @ r, a, atol=atol)
        np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), atol=atol)
    np.testing.assert_allclose(np.abs(got[1]), np.abs(want[1]), atol=atol)


def _check_svd(args, got, want, atol):
    a = args[0]
    np.testing.assert_allclose(got[1], want[1], atol=atol)
    for u, s, vh in (got, want):
        np.testing.assert_allclose((u * s) @ vh, a, atol=atol)


def _check_eig(args, got, want, atol):
    a = args[0]
    gw, ww = np.sort_complex(got[0]), np.sort_complex(want[0])
    np.testing.assert_allclose(gw, ww, atol=atol)
    for w, v in (got, want):
        np.testing.assert_allclose(a @ v, v * w, atol=atol)


def _check_eigh(args, got, want, atol):
    a = args[0]
    np.testing.assert_allclose(got[0], want[0], atol=atol)
    for w, v in (got, want):
        np.testing.assert_allclose(a @ v, v * w, atol=atol)


def _check_eig_values(args, got, want, atol):
    np.testing.assert_allclose(np.sort_complex(got), np.sort_complex(want),
                               atol=atol)


STRUCTURAL = {"qr": _check_qr, "svd": _check_svd, "eig": _check_eig,
              "eigh": _check_eigh, "eig_values": _check_eig_values}


def check(case, got, want=None, atol=1e-5, rtol=1e-5):
    """Hold ``got`` (numpy tree) to ``want`` under ``case``'s rule; a
    ``"random"`` case checks ``got``'s distribution alone (and ``want``'s,
    when given). Raises ``AssertionError``."""
    if case.tol is not None:
        atol = rtol = max(atol, case.tol)
    if case.check == "random":
        for out in (got, want):
            if out is not None:
                case.stat(out)
        return
    if case.check in STRUCTURAL:
        STRUCTURAL[case.check](case.args, got, want, max(atol, 1e-4))
        return
    _tree(got, want, atol, rtol, case.name)


# -- distribution checks of the samplers -------------------------------------

def _near(value, want, sem, what):
    assert abs(value - want) <= 5 * sem + 1e-6, \
        f"{what}: {value} against {want} (5 standard errors: {5 * sem})"


def _moments(mean, var, lo=None, hi=None, integer=False):
    def stat(x):
        x = np.asarray(x, np.float64).reshape(-1)
        n = x.size
        _near(x.mean(), mean, np.sqrt(var / n), "mean")
        _near(x.var(), var, var * np.sqrt(2.0 / n) * 2, "variance")
        if lo is not None:
            assert x.min() >= lo, f"below the support: {x.min()} < {lo}"
        if hi is not None:
            assert x.max() <= hi, f"above the support: {x.max()} > {hi}"
        if integer:
            assert np.all(x == np.round(x)), "not integers"
    return stat


def _permutation(n):
    def stat(x):
        np.testing.assert_array_equal(np.sort(np.asarray(x)), np.arange(n))
    return stat


def _no_repeats(n_cls):
    def stat(x):
        x = np.asarray(x)
        assert x.dtype == np.int64
        assert x.min() >= 0 and x.max() < n_cls
        for row in x.reshape(-1, x.shape[-1]):
            assert len(set(row.tolist())) == row.size, row
    return stat


def _dropout(p, scale):
    def stat(x):
        x = np.asarray(x).reshape(-1)
        dropped = np.mean(x == 0)
        _near(dropped, p, np.sqrt(p * (1 - p) / x.size), "dropped share")
        np.testing.assert_allclose(x[x != 0], scale, rtol=1e-6)
    return stat


def _alpha_dropout(p):
    alpha = 1.6732632423543772 * 1.0507009873554805
    a = 1.0 / ((1.0 - p) * (1.0 + p * alpha ** 2)) ** 0.5
    b = -a * alpha * p

    def stat(x):
        x = np.asarray(x).reshape(-1)
        dropped = np.isclose(x, -alpha * a + b, atol=1e-5)
        kept = np.isclose(x, a + b, atol=1e-5)
        assert np.all(dropped | kept)
        _near(dropped.mean(), p, np.sqrt(p * (1 - p) / x.size),
              "dropped share")
    return stat


def _rrelu(lower, upper):
    def stat(x):
        ratio = np.asarray(x).reshape(-1) / -2.0
        assert ratio.min() >= lower - 1e-6 and ratio.max() <= upper + 1e-6
        _near(ratio.mean(), (lower + upper) / 2,
              (upper - lower) / np.sqrt(12 * ratio.size), "slope mean")
    return stat


def _simplex(x):
    x = np.asarray(x)
    assert np.all(x >= 0)
    np.testing.assert_allclose(x.sum(-1), 1.0, atol=1e-5)


# -- the cases -----------------------------------------------------------------

def cases(seed=0):
    """``{op name: Case}`` for every op of the library."""
    rs = np.random.RandomState(seed)

    def rnd(*shape):
        return rs.randn(*shape).astype(np.float32)

    def uni(lo, hi, *shape):
        return rs.uniform(lo, hi, shape).astype(np.float32)

    a, b = rnd(3, 4), rnd(3, 4)
    pos = uni(0.5, 2.0, 3, 4)
    unit = uni(-0.9, 0.9, 3, 4)
    prob = uni(0.1, 0.9, 3, 4)
    ia = rs.randint(-9, 10, (3, 4)).astype(np.int32)
    ib = rs.randint(1, 6, (3, 4)).astype(np.int32) * np.where(
        rs.rand(3, 4) < 0.5, -1, 1).astype(np.int32)
    bits = rs.randint(0, 64, (3, 4)).astype(np.int32)
    ba, bb = rs.rand(3, 4) < 0.5, rs.rand(3, 4) < 0.5
    special = a.copy()
    special[0, 0], special[1, 2], special[2, 3] = np.nan, np.inf, -np.inf
    with_nan = a.copy()
    with_nan[0, 1] = with_nan[2, 2] = np.nan
    ties = np.array([[3, 1, 3, 2], [5, 5, 1, 1], [0, 2, 2, 2]], np.float32)
    sq = rnd(4, 4)
    spd = sq @ sq.T + 4 * np.eye(4, dtype=np.float32)
    sym = (sq + sq.T) / 2
    img = rnd(2, 4, 6, 6)
    cplx = (rnd(3, 4) + 1j * rnd(3, 4)).astype(np.complex64)
    n = 20000
    c = {}

    def add(name, *args, check="close", creation=False, stat=None,
            tol=None, **attrs):
        c[name] = Case(name, args, attrs, check, creation, stat, tol)

    # math_ops: binary, unary, predicates
    for name in ("add", "subtract", "multiply", "divide", "maximum",
                 "minimum", "fmax", "fmin", "atan2", "logaddexp",
                 "nextafter", "copysign", "hypot", "divide_trunc"):
        add(name, a, b)
    for name in ("floor_divide", "mod", "remainder"):
        add(name, ia, ib, check="exact")
    add("pow", pos, b)
    add("heaviside", np.round(a), b)
    add("ldexp", a, rs.randint(-3, 4, (3, 4)).astype(np.int32))
    for name in ("exp", "expm1", "abs", "sign", "sin", "cos", "tan", "atan",
                 "sinh", "cosh", "tanh", "asinh", "floor", "ceil", "trunc",
                 "frac", "square", "neg", "erf", "sigmoid"):
        add(name, a)
    add("round", np.array([[0.5, 1.5, -0.5, 2.5], [0.4, -1.6, 3.2, -2.5]],
                          np.float32))
    add("rint", 3 * a)
    for name in ("log", "log2", "log10", "log1p", "sqrt", "rsqrt",
                 "reciprocal", "lgamma", "digamma", "i0", "i1"):
        add(name, pos)
    add("acosh", pos + 1)
    for name in ("asin", "acos", "atanh", "erfinv"):
        add(name, unit)
    add("logit_raw", prob)
    for name in ("angle", "conj", "real", "imag"):
        add(name, cplx)
    add("scale", a, scale=2.0, bias=1.0, bias_after_scale=False)
    add("clip", a, min=-0.5, max=0.5)
    add("logit", prob, eps=0.2)
    add("stanh", a)
    for name in ("isnan", "isinf", "isfinite", "signbit"):
        add(name, special, check="exact")
    for name in ("equal", "not_equal", "greater_than", "greater_equal",
                 "less_than", "less_equal"):
        add(name, np.round(a), np.round(b), check="exact")
    for name in ("logical_and", "logical_or", "logical_xor"):
        add(name, ba, bb, check="exact")
    add("logical_not", ba, check="exact")
    for name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        add(name, bits, bits[::-1].copy(), check="exact")
    add("bitwise_not", bits, check="exact")
    add("isclose", a, a + 1e-6, check="exact", atol=1e-8, rtol=1e-6)
    add("allclose", a, a + 1e-3, check="exact")
    add("equal_all", ia, ia.copy(), check="exact")
    # reductions
    add("sum", ba, axis=1, check="exact")
    add("mean", a, axis=(0, 1), keepdim=True)
    add("max", a, axis=0, keepdim=True)
    add("min", a, axis=1)
    add("prod", ia, axis=1, check="exact")
    add("amax", a, axis=[0, 1])
    add("amin", a)
    add("nansum", with_nan, axis=1)
    add("nanmean", with_nan, axis=0)
    add("all", ba, axis=1, check="exact")
    add("any", ba, axis=0, keepdim=True, check="exact")
    add("argmax", a, axis=1, check="exact")
    add("argmin", a, check="exact")
    add("logsumexp", a, axis=1, keepdim=True)
    add("cumsum", ia, axis=1, check="exact")
    add("cumprod", a, dim=0)
    add("cummax", a, axis=1)
    add("cummin", a, axis=0)
    add("median", a, axis=1)
    add("quantile", a, [0.25, 0.5], axis=1)
    add("count_nonzero", np.round(a), axis=0, check="exact")
    add("var", a, axis=1)
    add("std", a, unbiased=False)
    add("kthvalue", ties, 2, axis=1)
    add("trace_reduce", sq, offset=1)
    # extra_math_ops
    add("add_n", [a, b, pos])
    add("lerp", a, b, prob)
    add("deg2rad", a)
    add("rad2deg", a)
    add("gcd", ia, ib, check="exact")
    add("lcm", ia, ib, check="exact")
    add("diff", a, a[:, :1].copy(), None, n=2, axis=1)
    add("dist", a, b, p=3.0)
    add("logcumsumexp", a, axis=1)
    add("mode", ties, axis=1)
    add("multiplex", [a, b], np.array([[1], [0], [1]], np.int32))
    add("nanmedian", with_nan, axis=1)
    add("nanquantile", with_nan, 0.4, axis=1)
    add("cov", a)
    add("corrcoef", a, rowvar=False)
    lu = np.array([[4.0, 3.0, 2.0], [0.5, 1.5, 1.0], [0.25, 0.5, 2.0]],
                  np.float32)
    add("lu_unpack", lu, np.array([3, 3, 3], np.int32))
    add("shard_index", rs.randint(0, 20, (3, 4)).astype(np.int64),
        index_num=20, nshards=4, shard_id=1, check="exact")
    add("as_complex", rnd(3, 2))
    add("as_real", cplx)
    add("make_complex", a, b)
    add("randint_like", np.zeros(n, np.float32), KEY, 0, 5, check="random",
        stat=_moments(2.0, 2.0, 0, 4, integer=True))
    # creation_ops
    add("full", (2, 3), 1.5, dtype="float32", creation=True)
    add("zeros", (2, 3), dtype="float32", creation=True)
    add("arange", 2, 9, 3, dtype="int64", creation=True, check="exact")
    add("linspace", 0.0, 1.0, 5, dtype="float32", creation=True)
    add("logspace", 0.0, 2.0, 5, base=2.0, dtype="float32", creation=True)
    add("eye", 3, 4, dtype="float32", creation=True)
    add("full_like", a, 2.5)
    add("tril", a, 1)
    add("triu", a, -1)
    add("diag", a[0].copy(), offset=1, padding_value=7.0)
    add("diagflat", a[:2, :2].copy(), offset=-1)
    add("diag_embed", a, offset=1)
    add("diagonal", rnd(2, 3, 4), offset=1, axis1=1, axis2=2)
    add("meshgrid", [a[0].copy(), b[:, 0].copy()])
    add("assign", a)
    add("cast", 3 * a, dtype="int32", check="exact")
    add("uniform_random", KEY, shape=(n,), dtype="float32", min=-2.0,
        max=3.0, creation=True, check="random",
        stat=_moments(0.5, 25 / 12, -2.0, 3.0))
    add("gaussian_random", KEY, shape=(n,), dtype="float32", mean=1.0,
        std=2.0, creation=True, check="random", stat=_moments(1.0, 4.0))
    add("randint", KEY, 0, 5, shape=(n,), creation=True, check="random",
        stat=_moments(2.0, 2.0, 0, 4, integer=True))
    add("randperm", KEY, 50, creation=True, check="random",
        stat=_permutation(50))
    add("bernoulli", KEY, np.full(n, 0.3, np.float32), check="random",
        stat=_moments(0.3, 0.21, 0, 1, integer=True))
    add("multinomial", KEY, uni(0.1, 1.0, 4, 6), num_samples=3,
        check="random", stat=_no_repeats(6))
    add("standard_gamma", KEY, np.full(n, 2.0, np.float32), check="random",
        stat=_moments(2.0, 2.0, 0))
    add("poisson", KEY, np.full(n, 3.0, np.float32), check="random",
        stat=_moments(3.0, 3.0, 0, integer=True))
    add("exponential", KEY, np.zeros(n, np.float32), lam=2.0,
        check="random", stat=_moments(0.5, 0.25, 0))
    add("dropout_raw", np.ones(n, np.float32), KEY, p=0.3, check="random",
        stat=_dropout(0.3, 1 / 0.7))
    # manipulation_ops
    a3 = rnd(2, 3, 4)
    add("reshape", a, (0, 2, -1))
    add("transpose", a3, (2, 0, 1))
    add("concat", [a, b], axis=1)
    add("stack", [a, b], axis=1)
    add("unstack", a, axis=1)
    add("split", a, [1, -1, 2], axis=1)
    add("squeeze", rnd(1, 3, 1, 4), axis=[0, 2])
    add("unsqueeze", a, [0, 2])
    add("flatten", a3, start_axis=1)
    add("gather", a, np.array([2, 0], np.int64), axis=1)
    add("gather_nd", a, np.array([[0, 1], [2, 3]], np.int64))
    add("scatter", a, np.array([2, 0], np.int64), rnd(2, 4),
        overwrite=False)
    add("scatter_nd_add", a, np.array([[0], [2], [0]], np.int64),
        rnd(3, 4))
    add("index_select", a, np.array([3, 0, 3], np.int64), axis=1)
    add("index_sample", a, np.array([[0, 3], [1, 1], [2, 0]], np.int64))
    add("take_along_axis", a, np.array([[0, 3], [1, 1], [2, 0]], np.int64),
        axis=1)
    add("put_along_axis", a, np.array([[1], [3], [0]], np.int64),
        rnd(3, 1), axis=1, reduce="multiply")
    add("where", ba, a, b)
    add("nonzero", ba, as_tuple=True, check="exact")
    add("masked_select", a, ba)
    add("masked_fill", a, np.array([True, False, True]), value=9.0)
    add("tile", a, [2, 1])
    add("expand", a[:1].copy(), (3, -1))
    add("broadcast_to", a[:, :1].copy(), (3, 4))
    add("expand_as", a[:1].copy(), b)
    add("flip", a, [0, 1])
    add("roll", a, 2)
    add("rot90", a, k=3, axes=(1, 0))
    add("pad", img, [1, 2, 0, 1], mode="reflect")
    add("chunk", a, 3, axis=1)
    add("unique", np.array([3, 1, 2, 3, 1, 5, 2], np.int64),
        return_index=True, return_inverse=True, return_counts=True,
        check="exact")
    add("unique_consecutive", np.array([1, 1, 2, 2, 2, 3, 1, 1], np.int64),
        return_inverse=True, return_counts=True, check="exact")
    add("sort", ties, axis=1, descending=True)
    add("argsort", ties, axis=1, descending=True, check="exact")
    add("topk", ties, 2, largest=False)
    add("searchsorted", np.array([1.0, 2.0, 2.0, 5.0], np.float32),
        np.array([2.0, 0.5, 6.0], np.float32), right=True, check="exact")
    add("bucketize", np.array([2.0, 0.5, 6.0], np.float32),
        np.array([1.0, 2.0, 5.0], np.float32), out_int32=True,
        check="exact")
    add("one_hot", np.array([[1, 4], [0, -1]], np.int64), 5)
    add("repeat_interleave", a, 2, axis=0)
    add("getitem", a3, np.array([1, 0], np.int64),
        index_spec=(("slice", None, None, -1), ("none",), ("array",),
                    ("slice", 3, 0, -2)))
    add("setitem", a3, np.float32(7.0), index_spec=(
        ("int", 1), ("ellipsis",), ("slice", None, None, -2)))
    add("strided_slice", a3, [0, 2], [1, 3], [-3, 0], [-1, -2])
    add("slice", a3, [1, 2], [1, 0], [3, 2])
    add("moveaxis", a3, 0, 2)
    add("swapaxes", a3, 0, 2)
    add("as_strided", a, (2, 3), (4, 1), offset=1)
    add("tensordot", a3, rnd(4, 3, 5), axes=[[1, 2], [1, 0]])
    add("crop", a3, (1, 2, 3), (1, 1, 0))
    add("masked_fill_tensor", a, ba, np.arange(int(ba.sum()),
                                              dtype=np.float32))
    # linalg_ops
    add("matmul", a, b, transpose_y=True)
    add("dot", a, b)
    add("bmm", a3, rnd(2, 4, 5))
    add("mv", a, b[0].copy())
    add("outer", a[0].copy(), b[:, 0].copy())
    add("inner", a, b)
    add("cross", rnd(3, 4), rnd(3, 4))
    add("kron", a[:2, :2].copy(), b[:2, :3].copy())
    add("addmm", rnd(3, 5), a, rnd(4, 5), beta=0.5, alpha=2.0)
    add("einsum", [a, b], equation="ij,kj->ik")
    add("p_norm", a, porder=3.0, axis=1)
    add("frobenius_norm", a3, axis=[1, 2], keepdim=True)
    add("cholesky", spd, tol=1e-4)
    add("inverse", spd, tol=1e-4)
    add("pinv", a, tol=1e-4)
    add("matrix_rank", a, check="exact")
    add("slogdet", sq, tol=1e-4)
    add("det", sq, tol=1e-4)
    add("qr", rnd(5, 3), check="qr")
    add("svd", rnd(5, 3), check="svd")
    add("eig", sq, check="eig")
    add("eigh", sym, check="eigh")
    add("eigvals", sq, check="eig_values", tol=1e-4)
    add("eigvalsh", sym, tol=1e-4)
    add("matrix_power", sq / 2, 3, tol=1e-4)
    add("solve", spd, rnd(4, 2), tol=1e-4)
    add("triangular_solve", np.triu(spd), rnd(4, 2), upper=True,
        transpose=True, tol=1e-4)
    add("cholesky_solve", rnd(4, 2), np.linalg.cholesky(spd).astype(
        np.float32), tol=1e-4)
    add("lstsq", rnd(5, 3), rnd(5, 2), tol=1e-4)
    add("lu", spd, tol=1e-4)
    add("histogram", a, bins=5, min=-2, max=2, check="exact")
    add("bincount", np.array([0, 1, 1, 3, 1], np.int64),
        uni(0.0, 1.0, 5), minlength=6)
    boxes = np.array([[[0, 0, 10, 10], [1, 1, 10, 10], [20, 20, 30, 30],
                       [0, 0, 9, 11]]], np.float32)
    scores = np.array([[[0.9, 0.8, 0.7, 0.6], [0.2, 0.85, 0.3, 0.1]]],
                      np.float32)
    add("matrix_nms", boxes, scores, score_threshold=0.05,
        post_threshold=0.1, normalized=False, background_label=-1)
    add("cond", spd, tol=1e-3)
    add("multi_dot", [a, rnd(4, 5), rnd(5, 2)])
    # nn_ops: activations
    for name in ("relu", "relu6", "silu", "swish", "softplus_raw",
                 "softsign", "mish", "hardswish", "tanhshrink",
                 "log_sigmoid", "elu", "selu",
                 "hardsigmoid", "hardtanh", "hardshrink", "softshrink",
                 "thresholded_relu", "log_softmax", "glu"):
        add(name, 4 * a)
    add("gelu", a, approximate=True)
    add("leaky_relu", a, negative_slope=0.2)
    add("celu", a, alpha=0.5)
    add("softplus", 10 * a, beta=2.0, threshold=15.0)
    add("softmax", a, axis=0)
    add("prelu", img, uni(0.0, 0.5, 4))
    add("maxout", img, 2, axis=1)
    add("alpha_dropout", np.ones(n, np.float32), KEY, p=0.2,
        check="random", stat=_alpha_dropout(0.2))
    add("rrelu", np.full(n, -2.0, np.float32), KEY, lower=0.1, upper=0.3,
        check="random", stat=_rrelu(0.1, 0.3))
    add("gumbel_softmax", rnd(64, 5), KEY, temperature=0.5, check="random",
        stat=_simplex)
    # linear, embedding, conv, pool
    add("spectral_norm", rnd(4, 6), rnd(4), rnd(6), power_iters=3)
    add("bilinear", rnd(2, 3), rnd(2, 5), rnd(4, 3, 5), rnd(4))
    add("linear", a, rnd(4, 6), rnd(6))
    add("embedding", np.array([[1, 0, 3], [2, 2, 0]], np.int64), rnd(5, 4),
        padding_idx=-5)
    w2 = rnd(6, 2, 3, 3)
    add("conv2d", img, w2, rnd(6), stride=2, padding=[1, 0, 2, 1],
        groups=2)
    add("conv1d", rnd(2, 4, 9), rnd(6, 4, 3), None, padding="SAME",
        dilation=2)
    add("conv3d", rnd(1, 2, 5, 5, 5), rnd(3, 2, 2, 2, 2), rnd(3), stride=1,
        padding=1)
    add("conv2d_transpose", img, rnd(4, 3, 3, 3), rnd(6), stride=2,
        padding=[1, 0], output_padding=1, groups=2)
    add("max_pool2d", img, 3, stride=2, padding=1, ceil_mode=True)
    add("avg_pool2d", img, 3, stride=2, padding=1, ceil_mode=True)
    add("max_pool1d", rnd(2, 3, 9), 2, stride=3, padding=1)
    add("avg_pool1d", rnd(2, 3, 9), 3, stride=2, padding=1,
        exclusive=False)
    add("max_pool3d", rnd(1, 2, 5, 5, 5), 2, padding=1, ceil_mode=True)
    add("avg_pool3d", rnd(1, 2, 5, 5, 5), 3, stride=2, padding=1)
    add("adaptive_avg_pool2d", img, (4, None))
    add("adaptive_max_pool2d", img, 4)
    add("adaptive_avg_pool1d", rnd(2, 3, 10), 4)
    add("adaptive_max_pool1d", rnd(2, 3, 10), 3)
    # normalization
    add("layer_norm", a3, rnd(3, 4), rnd(3, 4), begin_norm_axis=1)
    add("batch_norm", img, uni(-1, 1, 4), uni(0.5, 2, 4), rnd(4), rnd(4),
        training=True, momentum=0.8)
    add("instance_norm", img, rnd(4), rnd(4))
    add("group_norm", img, rnd(4), rnd(4), num_groups=2)
    add("rms_norm", a, rnd(4))
    add("local_response_norm", img, size=3, alpha=0.1)
    add("normalize_l2", a, p=3.0, axis=1)
    # losses
    lab = np.array([0, 3, -100], np.int64)
    add("softmax_with_cross_entropy", a, lab[:, None], return_softmax=True)
    add("cross_entropy", a, np.array([0, 3, 1], np.int64), uni(0.5, 2, 4),
        label_smoothing=0.1)
    add("mse_loss", a, b)
    add("l1_loss", a, b, reduction="sum")
    add("smooth_l1_loss", a, b, reduction="none", delta=0.5)
    add("huber_loss", a, b, delta=0.5)
    add("nll_loss", np.log(prob), lab, uni(0.5, 2, 4))
    add("bce_loss", prob, (rs.rand(3, 4) < 0.5).astype(np.float32),
        uni(0.5, 2, 4))
    add("bce_with_logits", a, (rs.rand(3, 4) < 0.5).astype(np.float32),
        None, uni(0.5, 2, 4))
    add("kl_div", np.log(prob), prob[::-1].copy(), reduction="batchmean")
    add("margin_ranking_loss", a, b, np.sign(rnd(3, 4)), margin=0.1)
    add("hinge_embedding_loss", a, np.sign(rnd(3, 4)), margin=0.5)
    add("cosine_similarity", a, b, axis=1)
    add("label_smooth", np.eye(4, dtype=np.float32)[[0, 3, 1]],
        epsilon=0.2)
    add("sigmoid_focal_loss", a, (rs.rand(3, 4) < 0.5).astype(np.float32),
        np.float32(2.0))
    # resizing, rearrangement, attention
    add("interpolate", img, size=(4, 9), mode="bilinear")
    c["interpolate_bicubic"] = Case("interpolate", (img,), dict(
        size=(3, 8), mode="bicubic"))
    c["interpolate_nearest"] = Case("interpolate", (img,), dict(
        scale_factor=(1.5, 0.5), mode="nearest"))
    c["interpolate_corners"] = Case("interpolate", (img,), dict(
        size=(4, 9), mode="bilinear", align_corners=True))
    add("pixel_shuffle", rnd(2, 8, 3, 3), 2)
    add("unfold", img, 3, strides=2, paddings=[1, 0, 0, 1], dilations=1)
    add("sequence_mask", np.array([1, 3, 0], np.int64), maxlen=4,
        check="exact")
    q = rnd(2, 6, 2, 8)
    add("scaled_dot_product_attention", q, rnd(2, 6, 2, 8), rnd(2, 6, 2, 8),
        mask=rnd(2, 1, 6, 6))
    # extra cases of ops whose attributes choose a different path
    c["floor_divide_float"] = Case("floor_divide", (a, b))
    c["mod_float"] = Case("mod", (a, b))
    c["put_along_axis_assign"] = Case(
        "put_along_axis", (a, np.array([[1], [3], [0]], np.int64),
                           rnd(3, 1)), dict(axis=1))
    c["pad_constant"] = Case("pad", (img, [1, 2, 0, 1]), dict(
        mode="constant", value=2.0, data_format="NHWC"))
    c["pad_circular"] = Case("pad", (a, [1, 2, 2, 1]), dict(
        mode="circular"))
    c["conv2d_nhwc"] = Case("conv2d", (np.moveaxis(img, 1, -1).copy(),
                                       rnd(5, 4, 3, 3)), dict(
        padding="SAME", stride=2, data_format="NHWC"))
    c["nonzero_rows"] = Case("nonzero", (ba,), check="exact")
    c["split_even"] = Case("split", (a, 2), dict(axis=1))
    c["roll_axis"] = Case("roll", (a, (1, -1)), dict(axis=(0, 1)))
    _extra_nn_cases(c, np.random.RandomState(seed + 1))
    _sequence_cases(c, np.random.RandomState(seed + 2))
    _vision_cases(c, np.random.RandomState(seed + 3))
    return c


def _class_centers(label, num_classes, num_samples):
    """The rule of ``class_center_sample``: every class of ``label`` kept,
    at least ``num_samples`` sorted distinct ids, the labels remapped to
    their ids' positions."""
    def stat(out):
        remapped, sampled = (np.asarray(o) for o in out)
        pos = np.unique(label)
        assert sampled.dtype == remapped.dtype == np.int64
        assert len(sampled) == max(len(pos), num_samples), sampled
        np.testing.assert_array_equal(sampled, np.unique(sampled))
        assert sampled.min() >= 0 and sampled.max() < num_classes
        assert np.isin(pos, sampled).all()
        np.testing.assert_array_equal(sampled[remapped], label)
    return stat


def _extra_nn_cases(c, rs):
    """The cases of ``extra_nn_ops`` (their own stream, so that the cases
    above keep their inputs), several for the ops whose attributes choose
    another path."""
    def rnd(*shape):
        return rs.randn(*shape).astype(np.float32)

    def ints(lo, hi, *shape, dtype=np.int64):
        return rs.randint(lo, hi, shape).astype(dtype)

    def add(key, name, *args, check="close", stat=None, tol=None, **attrs):
        c[key] = Case(name, args, attrs, check, stat=stat, tol=tol)

    img = rnd(2, 4, 6, 6)
    add("conv1d_transpose", "conv1d_transpose", rnd(2, 4, 7),
        rnd(4, 3, 3), rnd(3), stride=2, padding=1, output_padding=1)
    add("conv1d_transpose_nlc", "conv1d_transpose", rnd(2, 7, 4),
        rnd(4, 3, 3), None, stride=1, padding="SAME", groups=2,
        dilation=2, data_format="NLC")
    add("conv3d_transpose", "conv3d_transpose", rnd(1, 2, 3, 3, 3),
        rnd(2, 3, 2, 2, 2), rnd(3), stride=2, padding=1, dilation=1)
    add("conv3d_transpose_ndhwc", "conv3d_transpose", rnd(1, 3, 3, 3, 4),
        rnd(4, 1, 3, 2, 2), None, stride=(1, 2, 1), padding="VALID",
        groups=2, data_format="NDHWC")
    add("adaptive_avg_pool3d", "adaptive_avg_pool3d", rnd(1, 2, 5, 6, 4),
        (2, 3, None))
    add("adaptive_avg_pool3d_ndhwc", "adaptive_avg_pool3d",
        rnd(1, 5, 6, 4, 2), 3, data_format="NDHWC")
    add("adaptive_max_pool3d", "adaptive_max_pool3d", rnd(1, 2, 5, 6, 4),
        (2, 3, 4))
    add("fold", "fold", rnd(2, 8, 16), (5, 5), 2)
    add("fold_padded", "fold", rnd(2, 8, 9), (5, 5), 2, strides=2,
        paddings=[1, 0, 0, 1])
    add("max_pool1d_with_mask", "max_pool1d_with_mask", rnd(2, 3, 9), 2,
        stride=3, padding=1)
    add("max_pool2d_with_mask", "max_pool2d_with_mask", img, 3, stride=2,
        padding=1, ceil_mode=True)
    add("max_pool3d_with_mask", "max_pool3d_with_mask", rnd(1, 2, 5, 5, 5),
        2, padding=1, ceil_mode=True)

    def unpool_index(n, ch, length, size):
        return np.stack([rs.permutation(size)[:length]
                         for _ in range(n * ch)]).reshape(
            (n, ch, length)).astype(np.int32)

    add("max_unpool1d", "max_unpool1d", rnd(2, 3, 4),
        unpool_index(2, 3, 4, 8), 2)
    add("max_unpool2d", "max_unpool2d", rnd(2, 3, 3, 3),
        unpool_index(2, 3, 9, 36).reshape(2, 3, 3, 3), 2, stride=2)
    add("max_unpool2d_size", "max_unpool2d", rnd(2, 3, 3, 3),
        unpool_index(2, 3, 9, 49).reshape(2, 3, 3, 3), 2,
        output_size=(2, 3, 7, 7))
    add("max_unpool3d", "max_unpool3d", rnd(1, 2, 2, 2, 2),
        unpool_index(1, 2, 8, 64).reshape(1, 2, 2, 2, 2), 2)
    add("pixel_unshuffle", "pixel_unshuffle", rnd(2, 3, 4, 6), 2)
    add("pixel_unshuffle_nhwc", "pixel_unshuffle", rnd(2, 4, 6, 3), 2,
        data_format="NHWC")
    add("channel_shuffle", "channel_shuffle", rnd(2, 6, 3, 3), 3)
    add("channel_shuffle_nhwc", "channel_shuffle", rnd(2, 3, 3, 6), 2,
        data_format="NHWC")
    add("temporal_shift", "temporal_shift", rnd(4, 8, 3, 3), 2)
    add("temporal_shift_nhwc", "temporal_shift", rnd(6, 3, 3, 8), 3,
        shift_ratio=0.125, data_format="NHWC")
    x_gs = rnd(2, 3, 5, 6)
    grid = rs.uniform(-1.2, 1.2, (2, 4, 7, 2)).astype(np.float32)
    add("grid_sample", "grid_sample", x_gs, grid)
    add("grid_sample_nearest_border", "grid_sample", x_gs, grid,
        mode="nearest", padding_mode="border")
    add("grid_sample_reflection", "grid_sample", x_gs, grid,
        padding_mode="reflection", align_corners=False)
    theta = rnd(2, 2, 3)
    add("affine_grid", "affine_grid", theta, (2, 3, 5, 6))
    add("affine_grid_corners", "affine_grid", theta, (2, 3, 4, 7),
        align_corners=False)
    add("gather_tree", "gather_tree", ints(0, 10, 5, 2, 3),
        ints(0, 3, 5, 2, 3), check="exact")
    labels = np.array([[1, 2, 2], [3, 1, 0], [4, 4, 1]], np.int32)
    add("ctc_loss", "ctc_loss", rnd(6, 3, 5), labels,
        np.array([6, 5, 4], np.int64), np.array([3, 2, 0], np.int64))
    add("ctc_loss_blank", "ctc_loss", rnd(7, 2, 4), labels[:2, :2] - 1,
        np.array([7, 3], np.int64), np.array([2, 1], np.int64), blank=3)
    add("hsigmoid_loss", "hsigmoid_loss", rnd(4, 6),
        np.array([0, 4, 2, 3], np.int64), rnd(4, 6), rnd(4), num_classes=5)
    add("hsigmoid_loss_custom", "hsigmoid_loss", rnd(3, 6),
        np.array([0, 1, 2], np.int64), rnd(5, 6), None,
        np.array([[0, 2, -1], [0, 1, 4], [3, -1, -1]], np.int64),
        np.array([[1, 0, 0], [0, 1, 1], [1, 0, 0]], np.int64),
        num_classes=6)
    cosines = rs.uniform(-0.9, 0.9, (4, 6)).astype(np.float32)
    add("margin_cross_entropy", "margin_cross_entropy", cosines,
        np.array([0, 5, 2, 2], np.int64), scale=8.0, return_softmax=True)
    add("margin_cross_entropy_m3", "margin_cross_entropy", cosines,
        np.array([[1], [1], [3], [4]], np.int64), margin1=0.9, margin2=0.2,
        margin3=0.1, scale=4.0)
    label = np.array([3, 7, 7, 12, 3, 0], np.int64)
    add("class_center_sample", "class_center_sample", label,
        num_classes=20, num_samples=8, check="random",
        stat=_class_centers(label, 20, 8))
    offset = np.array([[[0, 2, 3, 5, 7], [0, 1, 1, 4, 6]]], np.int32)
    columns = np.array([[[0, 3, 1, 0, 2, 1, 3, 0],
                         [2, 0, 1, 3, 0, 2, 0, 0]]], np.int32)
    add("sparse_attention", "sparse_attention", rnd(1, 2, 4, 8),
        rnd(1, 2, 4, 8), rnd(1, 2, 4, 8), offset, columns)
    add("sparse_attention_masks", "sparse_attention", rnd(1, 2, 4, 8),
        rnd(1, 2, 4, 8), rnd(1, 2, 4, 8), offset, columns,
        np.array([[0, 0, -1e9, 0]], np.float32), rnd(4, 4))


def _sequence_cases(c, rs):
    """The cases of ``sequence_ops`` (their own stream): a dense
    ``[3, 5, ...]`` batch with lengths 3, 5 and 1, every pool type, the
    pack/pad pair on one packed layout."""
    def rnd(*shape):
        return rs.randn(*shape).astype(np.float32)

    def add(key, name, *args, check="close", **attrs):
        c[key] = Case(name, args, attrs, check)

    lengths = np.array([3, 5, 1], np.int64)
    x = rnd(3, 5, 4)
    add("sequence_pad", "sequence_pad", rnd(9, 4), lengths, pad_value=-1.5,
        maxlen=6)
    add("sequence_unpad", "sequence_unpad", x, lengths, total_length=11)
    for pool in ("sum", "average", "sqrt", "max", "min", "first", "last"):
        add(f"sequence_pool_{pool}", "sequence_pool", x, lengths,
            pool_type=pool)
    ix = rs.randint(-9, 10, (3, 5, 2)).astype(np.int32)
    add("sequence_pool_max_int", "sequence_pool", ix, lengths,
        pool_type="MAX", check="exact")
    add("sequence_pool_sum_int", "sequence_pool", ix, lengths,
        check="exact")
    add("sequence_softmax", "sequence_softmax", rnd(3, 5), lengths)
    add("sequence_reverse", "sequence_reverse", x, lengths)
    add("sequence_expand", "sequence_expand", rnd(3, 4), lengths, maxlen=6)
    add("sequence_slice", "sequence_slice", x, lengths,
        np.array([1, 2, 0], np.int64), np.array([2, 4, 3], np.int64),
        maxlen=4)
    ids = rs.randint(1, 30, (3, 5)).astype(np.int64)
    add("sequence_enumerate", "sequence_enumerate", ids, lengths, 3,
        pad_value=0, check="exact")
    add("sequence_conv", "sequence_conv", x, lengths, rnd(12, 6), rnd(6),
        context_length=3, pad_value=0.5)
    add("sequence_conv_start", "sequence_conv", x, lengths, rnd(8, 3),
        None, context_length=2, context_start=0)
    add("sequence_concat", "sequence_concat", [x, rnd(3, 2, 4)],
        [lengths, np.array([2, 0, 1], np.int64)])
    add("row_conv", "row_conv", x, rnd(3, 4))
    add("sequence_scatter", "sequence_scatter", x,
        np.array([[0, 2], [4, 4], [1, 0]], np.int64), rnd(3, 2, 4))
    add("nce_loss", "nce_loss", rnd(4, 6), np.array([[1], [0], [7], [3]],
                                                    np.int64),
        rnd(8, 6), rnd(8), rs.randint(0, 8, (4, 3)).astype(np.int64))


def _boxes(rs, n, h, w, scale=1.0):
    """``n`` xyxy boxes over an ``h`` x ``w`` map (in input pixels at
    ``1 / scale``), some reaching past its edges."""
    x1 = rs.uniform(-1, w - 2, n)
    y1 = rs.uniform(-1, h - 2, n)
    x2 = x1 + rs.uniform(0.5, w / 2 + 1, n)
    y2 = y1 + rs.uniform(0.5, h / 2 + 1, n)
    return (np.stack([x1, y1, x2, y2], 1) / scale).astype(np.float32)


def _vision_cases(c, rs):
    """The cases of the detection ops (``vision_ops``, their own stream):
    the region ops over two images with 2 and 3 boxes, aligned or not,
    sampled adaptively or at a fixed ratio; NMS with scores, without and
    with ``top_k``; deformable convolution v2 and v1 with deformable
    groups and groups; YOLO decoding and loss over one 5 x 5 head of 3
    anchors and 4 classes, the ground truth in distinct cells (a cell two
    boxes claim leaves the JAX scatter's order unspecified)."""
    def rnd(*shape):
        return rs.randn(*shape).astype(np.float32)

    def add(key, name, *args, check="close", tol=None, **attrs):
        c[key] = Case(name, args, attrs, check, tol=tol)

    feat = rnd(2, 3, 8, 10)
    boxes = _boxes(rs, 5, 8, 10, scale=0.5)
    add("roi_align", "roi_align", feat, boxes, boxes_num=(2, 3),
        output_size=3, spatial_scale=0.5)
    add("roi_align_unaligned", "roi_align", feat, boxes, boxes_num=(2, 3),
        output_size=(2, 3), spatial_scale=0.5, sampling_ratio=2,
        aligned=False)
    add("roi_pool", "roi_pool", feat, boxes, boxes_num=(2, 3),
        output_size=(3, 2), spatial_scale=0.5)
    # bins whose ends fall on integers (7 cells in 3 bins, 6 in 7): a
    # quotient rounded another way moves a bin by a cell
    add("roi_pool_edges", "roi_pool", rnd(2, 2, 8, 10),
        np.array([[0, 0, 6, 3], [1, 0, 7, 5]], np.float32),
        boxes_num=(1, 1), output_size=(3, 7))
    add("psroi_pool", "psroi_pool", rnd(2, 8, 8, 10), boxes,
        boxes_num=(2, 3), output_size=2, spatial_scale=0.5)
    nb = _boxes(rs, 12, 16, 16)
    nb[3] = nb[1] + 0.2                       # an overlap that suppresses
    scores = rs.rand(12).astype(np.float32)
    add("nms", "nms", nb, scores, iou_threshold=0.4, check="exact")
    add("nms_top_k", "nms", nb, scores, iou_threshold=0.2, top_k=3,
        check="exact")
    add("nms_unscored", "nms", nb, None, iou_threshold=0.3, check="exact")
    x = rnd(2, 4, 7, 7)
    add("deform_conv2d", "deform_conv2d", x, rnd(2, 18, 7, 7) * 1.5,
        rnd(6, 4, 3, 3), 1 / (1 + np.exp(-rnd(2, 9, 7, 7))), rnd(6),
        padding=1)
    add("deform_conv2d_groups", "deform_conv2d", x, rnd(2, 36, 3, 3),
        rnd(6, 2, 3, 3), None, None, stride=2, padding=0,
        deformable_groups=2, groups=2)
    anchors = (10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
               156, 198, 373, 326)
    head = rnd(2, 3 * 9, 5, 5)
    add("yolo_box", "yolo_box", head,
        np.array([[160, 160], [150, 170]], np.int32), anchors=anchors[:6],
        class_num=4, conf_thresh=0.3, downsample_ratio=32)
    add("yolo_box_scaled", "yolo_box", head,
        np.array([[160, 160], [150, 170]], np.int32), anchors=anchors[6:12],
        class_num=4, conf_thresh=0.01, downsample_ratio=32, clip_bbox=False,
        scale_x_y=1.05)
    cells = rs.permutation(25)[:8].reshape(2, 4)
    gt = np.zeros((2, 4, 4), np.float32)
    gt[..., 0] = (cells % 5 + rs.uniform(0.1, 0.9, (2, 4))) / 5
    gt[..., 1] = (cells // 5 + rs.uniform(0.1, 0.9, (2, 4))) / 5
    gt[..., 2:] = rs.uniform(0.03, 0.6, (2, 4, 2))
    gt[1, 3] = 0.0                            # a padded row
    labels = rs.randint(0, 4, (2, 4)).astype(np.int32)
    for key, mask, extra in (("yolo_loss", (0, 1, 2), {}),
                             ("yolo_loss_scored", (3, 4, 5), dict(
                                 use_label_smooth=False, scale_x_y=1.1))):
        args = (head, gt, labels) if not extra else (
            head, gt, labels, rs.uniform(0.5, 1, (2, 4)).astype(np.float32))
        add(key, "yolo_loss", *args, anchors=anchors, anchor_mask=mask,
            class_num=4, ignore_thresh=0.5, downsample_ratio=32, **extra)

