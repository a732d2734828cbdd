"""``framework/infermeta.py`` in the port against the JAX package's.

* Every curated shape check (matmul, concat, conv2d, embedding, linear,
  cross_entropy, batch_norm, reshape, split, one_hot, transpose, expand,
  gather, layer_norm) on a bad call: ``call_op`` raises ``ShapeError``
  in both packages, before the op runs, with the same message; on a good
  call it raises nothing in either and the port's op runs.
* ``FLAGS_check_shapes`` is on by default, as in the JAX package; off,
  the bad call fails inside the op instead (not a ``ShapeError``).
* A check reads shapes and attributes only: on ``meta`` tensors, which
  hold no values, it raises and passes as on real ones.
* ``infer_meta`` gives the output shapes and dtypes without computing,
  from tensors or from any object with ``shape`` and ``dtype``, as the
  JAX ``infer_meta`` does from ``jax.ShapeDtypeStruct``.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import dispatch as jax_dispatch
from paddle_tpu.framework import infermeta as jax_meta
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import infermeta
from paddle_tpu_torch.framework.dispatch import call_op


def z(*shape, dtype=np.float32):
    return np.zeros(shape, dtype)


IDX = np.array([0, 1], np.int64)

#: op -> (bad call, good call), each ``(args, attrs)`` over numpy
CASES = {
    "matmul": (((z(2, 3), z(4, 5)), {}),
               ((z(2, 3), z(5, 3)), {"transpose_y": True})),
    "concat": ((([z(2, 3), z(2, 4)],), {"axis": 0}),
               (([z(2, 3), z(2, 4)],), {"axis": 1})),
    "conv2d": (((z(1, 3, 8, 8), z(4, 5, 3, 3)), {}),
               ((z(1, 3, 8, 8), z(4, 3, 3, 3)), {})),
    "embedding": (((IDX, z(4, 3, 2)), {}), ((IDX, z(4, 3)), {})),
    "linear": (((z(2, 7), z(8, 4)), {}), ((z(2, 8), z(8, 4), z(4)), {})),
    "cross_entropy": (((z(4, 5), np.zeros((4, 2, 2), np.int64)), {}),
                      ((z(4, 5), np.zeros((4,), np.int64)), {})),
    "batch_norm": (((z(2, 4, 3, 3), z(5), np.ones(5, np.float32)), {}),
                   ((z(2, 4, 3, 3), z(4), np.ones(4, np.float32)), {})),
    "reshape": (((z(2, 3),), {"shape": [-1, 4]}),
                ((z(2, 3),), {"shape": [3, -1]})),
    "split": (((z(2, 5),), {"num_or_sections": 2, "axis": 1}),
              ((z(2, 6),), {"num_or_sections": [2, 4], "axis": 1})),
    "one_hot": (((IDX,), {"num_classes": 0}),
                ((IDX,), {"num_classes": 3})),
    "transpose": (((z(2, 3),), {"perm": (0, 0)}),
                  ((z(2, 3),), {"perm": (1, 0)})),
    "expand": (((z(2, 3),), {"shape": (2, 4)}),
               ((z(2, 3),), {"shape": (4, 2, 3)})),
    "gather": (((z(2, 3), IDX), {"axis": 3}), ((z(2, 3), IDX), {"axis": 1})),
    "layer_norm": (((z(2, 4), z(5)), {"begin_norm_axis": 1}),
                   ((z(2, 4), z(4), z(4)), {"begin_norm_axis": 1})),
}


def _args(args, fn):
    return [[fn(v) for v in a] if isinstance(a, list) else fn(a)
            for a in args]


def test_every_jax_check_is_ported():
    assert set(infermeta._VALIDATORS) == set(jax_meta._VALIDATORS) \
        == set(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_bad_call_raises_the_jax_shape_error(name):
    (args, attrs), _ = CASES[name]
    assert pt.get_flags("FLAGS_check_shapes")["FLAGS_check_shapes"]
    with pytest.raises(jax_meta.ShapeError) as want:
        jax_dispatch.call_op(name, *_args(args, paddle.to_tensor), **attrs)
    with pytest.raises(infermeta.ShapeError) as got:
        call_op(name, *_args(args, torch.from_numpy), **attrs)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_good_call_passes_both_checks_and_runs(name):
    _, (args, attrs) = CASES[name]
    jax_meta.maybe_check(name, _args(args, paddle.to_tensor), attrs)
    infermeta.maybe_check(name, _args(args, torch.from_numpy), attrs)
    out = call_op(name, *_args(args, torch.from_numpy), **attrs)
    assert out is not None


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_check_reads_no_value(name):
    (bad, bad_attrs), (good, good_attrs) = CASES[name]

    def meta(a):
        return torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                           device="meta")

    with pytest.raises(infermeta.ShapeError):
        infermeta.maybe_check(name, _args(bad, meta), bad_attrs)
    infermeta.maybe_check(name, _args(good, meta), good_attrs)


def test_the_flag_turns_the_checks_off():
    (args, attrs), _ = CASES["matmul"]
    pt.set_flags({"FLAGS_check_shapes": False})
    try:
        with pytest.raises(Exception) as e:
            call_op("matmul", *_args(args, torch.from_numpy), **attrs)
        assert not isinstance(e.value, infermeta.ShapeError)
    finally:
        pt.set_flags({"FLAGS_check_shapes": True})


def test_infer_meta_matches_jax():
    want = jax_meta.infer_meta("matmul",
                               jax.ShapeDtypeStruct((8, 16), np.float32),
                               jax.ShapeDtypeStruct((16, 32), np.float32))
    got = infermeta.infer_meta("matmul",
                               jax.ShapeDtypeStruct((8, 16), np.float32),
                               jax.ShapeDtypeStruct((16, 32), np.float32))
    assert tuple(got.shape) == want.shape == (8, 32)
    assert got.dtype == torch.float32 and got.device.type == "meta"
    conv = infermeta.infer_meta("conv2d", torch.zeros(2, 3, 8, 8),
                                torch.zeros(16, 3, 3, 3), stride=2,
                                padding=1)
    assert tuple(conv.shape) == (2, 16, 4, 4)
    outs = infermeta.infer_meta("max_pool2d_with_mask",
                                np.zeros((1, 2, 8, 8), np.float32),
                                kernel_size=2)
    jouts = jax_meta.infer_meta("max_pool2d_with_mask",
                                paddle.to_tensor(z(1, 2, 8, 8)),
                                kernel_size=2)
    assert [tuple(o.shape) for o in outs] == [o.shape for o in jouts]
    assert outs[1].dtype == torch.int32 and jouts[1].dtype == np.int32
