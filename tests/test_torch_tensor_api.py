"""The port's ``paddle.*`` functions (``paddle_tpu_torch.tensor``,
re-exported at the top level) against the JAX package's, on the same
numpy inputs: each function's own argument handling (shapes given as
lists or tensors, axis lists, ``p="fro"``, ``where`` with one argument,
``meshgrid`` of a list, ``split`` sections with -1, the in-place
variants) over the ops the op-library tests hold one by one. float32
within atol 1e-5 + rtol 1e-5, integers and booleans exactly; the
samplers by shape, dtype and support only."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import op_cases


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


A, B = _rand(1, 3, 4), _rand(2, 3, 4)
SQ = _rand(3, 4, 4) @ _rand(3, 4, 4).T + 4 * np.eye(4, dtype=np.float32)
I = np.array([[3, 1, 2], [0, 2, 1]], np.int64)

# name -> (args as numpy / Python values, kwargs)
CASES = {
    "zeros": (([2, 3],), {"dtype": "float32"}),
    "ones": (((2,),), {"dtype": "int32"}),
    "full": (([2, 2], 1.5), {}),
    "full_like": ((A, 7), {"dtype": "int64"}),
    "zeros_like": ((A,), {}),
    "arange": ((1, 10, 2), {}),
    "arange_float": ((0.0, 2.0, 0.5), {}),
    "linspace": ((0, 1, 5), {}),
    "logspace": ((0, 2, 3), {"base": 2.0}),
    "eye": ((3, 4), {}),
    "clone": ((A,), {}),
    "assign": ((A,), {}),
    "numel": ((A,), {}),
    "add": ((A, B), {}), "subtract": ((A, B), {}),
    "floor_mod": ((I, I + 1), {}),
    "scale": ((A,), {"scale": 2.0, "bias": 0.5, "act": "relu"}),
    "clip": ((A,), {"min": -0.5, "max": 0.25}),
    "cast": ((A, "int32"), {}),
    "sum": ((A,), {"axis": [0, 1], "keepdim": True}),
    "sum_bool": ((A > 0,), {"axis": 1}),
    "mean": ((A,), {"axis": -1}),
    "max": ((A,), {"axis": 0}),
    "prod": ((A,), {"axis": 1, "dtype": "float64"}),
    "var": ((A,), {"axis": 1, "unbiased": False}),
    "argmax": ((A,), {"axis": 1, "keepdim": True}),
    "cumsum": ((A,), {"axis": 0}),
    "kthvalue": ((A, 2), {"axis": 1}),
    "trace": ((SQ,), {"offset": 1}),
    "matmul": ((A, B), {"transpose_y": True}),
    "mm": ((A, B.T.copy()), {}),
    "addmm": ((_rand(4, 3, 3), A, B.T.copy()), {"beta": 0.5}),
    "einsum": (("ij,kj->ik", A, B), {}),
    "norm_fro": ((A,), {}),
    "norm_p": ((A,), {"p": 3, "axis": 1}),
    "cross": ((_rand(5, 3, 3), _rand(6, 3, 3)), {"axis": 1}),
    "cholesky": ((SQ,), {"upper": True}),
    "t": ((A,), {}),
    "histogram": ((A,), {"bins": 4, "min": -2, "max": 2}),
    "bincount": ((I.reshape(-1),), {"minlength": 5}),
    "reshape": ((A, [2, -1]), {}),
    "transpose": ((A, [1, 0]), {}),
    "concat": (([A, B],), {"axis": 1}),
    "stack": (([A, B],), {"axis": 2}),
    "unstack": ((A,), {"axis": 1}),
    "split": ((A, [1, -1]), {"axis": 1}),
    "chunk": ((A, 2), {"axis": 1}),
    "squeeze": ((A[None],), {"axis": 0}),
    "unsqueeze": ((A, [0, 3]), {}),
    "flatten": ((_rand(7, 2, 3, 4),), {"start_axis": 1}),
    "gather": ((A, np.array([2, 0])), {"axis": 1}),
    "scatter_nd": ((np.array([[1], [0]]), _rand(8, 2, 4), [3, 4]), {}),
    "index_select": ((A, np.array([3, 1])), {"axis": 1}),
    "put_along_axis": ((A, np.array([[1], [0], [3]]), 9.0, 1), {}),
    "where": ((A > 0, A, B), {}),
    "where_one": ((A > 0,), {}),
    "nonzero": ((A > 0,), {}),
    "masked_fill": ((A, A > 0, -1.0), {}),
    "tile": ((A, [1, 2]), {}),
    "expand": ((A[:1], [3, 4]), {}),
    "broadcast_to": ((A[:, :1], [3, 4]), {}),
    "broadcast_tensors": (([A, A[:1]],), {}),
    "flip": ((A, [0]), {}),
    "roll": ((A, [1, 2]), {"axis": [0, 1]}),
    "rot90": ((A,), {"k": 2}),
    "moveaxis": ((_rand(9, 2, 3, 4), [0, 1], [2, 0]), {}),
    "tril": ((A,), {"diagonal": 1}),
    "diag": ((A[0],), {"offset": -1}),
    "meshgrid": (([A[0], B[:, 0]],), {}),
    "sort": ((A,), {"axis": 0, "descending": True}),
    "topk": ((A, 2), {"axis": 0, "largest": False}),
    "searchsorted": ((np.sort(A[0]), B[0]), {}),
    "unique": ((I,), {"return_counts": True}),
    "one_hot": ((I, 4), {}),
    "repeat_interleave": ((A, 2), {"axis": 1}),
    "slice": ((A, [1], [1], [3]), {}),
    "strided_slice": ((A, [1], [3], [0], [-1]), {}),
    "crop": ((A,), {"shape": [2, 2], "offsets": [1, 1]}),
    "tensordot": ((A, B.T.copy()), {"axes": 1}),
    "add_n": (([A, B, A],), {}),
    "lerp": ((A, B, 0.25), {}),
    "diff": ((A,), {"n": 1, "axis": 0}),
    "dist": ((A, B), {"p": 1}),
    "logcumsumexp": ((A,), {"axis": 1}),
    "multiplex": (([A, B], np.array([[1], [0], [1]], np.int32)), {}),
    "nanmedian": ((A,), {"axis": 1}),
    "unbind": ((A,), {"axis": 0}),
    "cov": ((A,), {"rowvar": False}),
    "lu_unpack_infos": ((SQ,), {}),
    "shard_index": ((I, 4, 2, 1), {}),
    "complex": ((A, B), {}),
    "renorm": ((A, 2.0, 0, 1.0), {}),
    "tril_indices": ((4, 5, 1), {}),
    "triu_indices": ((3,), {}),
    "reverse": ((A, [1]), {}),
    "rank": ((A,), {}),
    "shape": ((A,), {}),
    "increment": ((A.copy(),), {"value": 2.0}),
    "reshape_": ((A.copy(), [4, 3]), {}),
    "eigh": ((SQ,), {}),
    "matrix_power": ((SQ / 4, 2), {}),
    "solve": ((SQ, A.T.copy()), {}),
    "pinv": ((A,), {}),
    "multi_dot": (([A, B.T.copy(), A],), {}),
}


def _call(mod, name, args, kwargs, to):
    fn = name.split("_")[0] if name in ("arange_float", "sum_bool",
                                        "norm_fro", "norm_p", "where_one",
                                        "lu_unpack_infos") else name
    conv = [to(a) if isinstance(a, np.ndarray) else
            [to(v) for v in a] if isinstance(a, list) and a and isinstance(
                a[0], np.ndarray) else a for a in args]
    if name == "lu_unpack_infos":
        lu, piv, info = getattr(mod, "lu")(*conv, get_infos=True)
        return getattr(mod, "lu_unpack")(lu, piv), info
    if name == "norm_fro":
        fn = "norm"
    return getattr(mod, fn)(*conv, **kwargs)


def _np(out):
    if isinstance(out, (list, tuple)):
        return [_np(o) for o in out]
    if isinstance(out, torch.Tensor):
        return op_cases.to_numpy_tree(out)
    if hasattr(out, "numpy"):
        return np.asarray(out.numpy())
    return np.asarray(out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_paddle_function_matches_the_jax_package(name):
    args, kwargs = CASES[name]
    got = _np(_call(pt, name, args, kwargs, lambda a: torch.tensor(a)))
    want = _np(_call(paddle, name, args, kwargs,
                     lambda a: paddle.to_tensor(a)))
    if name == "eigh":          # eigenvectors are unique up to signs
        np.testing.assert_allclose(got[0], want[0], atol=1e-4)
        np.testing.assert_allclose(np.abs(got[1]), np.abs(want[1]),
                                   atol=1e-4)
        return
    op_cases.check(op_cases.Case(name, args), got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("name, args", [
    ("rand", ([64, 64],)), ("randn", ([64, 64],)),
    ("uniform", ([64, 64],)), ("normal", (1.0, 2.0, [64, 64])),
    ("standard_normal", ([64, 64],)), ("randint", (0, 7, [64, 64])),
    ("randperm", (50,)), ("bernoulli", (np.full((64, 64), 0.5,
                                                np.float32),)),
    ("multinomial", (np.full((4, 6), 1 / 6, np.float32), 3)),
    ("poisson", (np.full((64, 64), 2.0, np.float32),)),
    ("standard_gamma", (np.full((64, 64), 2.0, np.float32),)),
    ("randint_like", (np.zeros((64, 64), np.float32), 0, 5)),
])
def test_paddle_samplers_match_the_jax_package_in_form(name, args):
    """Shape, dtype and range as the JAX function's (``standard_gamma``
    keeps its input's dtype, where the JAX function returns float64,
    ``jax.random.gamma``'s default dtype under x64); ``pt.seed`` repeats
    the port's draws."""
    got = []
    for _ in range(2):
        pt.seed(7)
        got.append(_np(_call(pt, name, args, {}, torch.tensor)))
    want = _np(_call(paddle, name, args, {}, paddle.to_tensor))
    assert got[0].shape == want.shape
    assert got[0].dtype == (np.float32 if name == "standard_gamma"
                            else want.dtype)
    np.testing.assert_array_equal(got[0], got[1])
    if name in ("rand", "uniform", "bernoulli", "randint", "randperm",
                "randint_like"):
        assert got[0].min() >= want.min() - 1 and got[0].max() <= \
            max(want.max(), 1) + 1e-6
