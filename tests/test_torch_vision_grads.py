"""Gradients of the port's detection ops
(``paddle_tpu_torch/ops/vision_ops.py``) against the JAX package's
(``paddle_tpu/vision/ops.py``), on the CPU, on the cases of
``ops/op_cases.py``'s ``_vision_cases``: the gradient of a random
cotangent against ``jax.vjp`` of the JAX op's body within atol 1e-4 +
rtol 1e-4 (float32 sums of up to a few hundred terms, in another order):
``deform_conv2d`` in its input, offsets, mask, weight and bias;
``yolo_loss``, ``roi_align``, ``roi_pool`` and ``psroi_pool`` in their
feature map. The region ops give the same values cut into chunks of one
region.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.vision.ops  # noqa: F401  (registers the vision ops)
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch.framework.dispatch import call_op
from paddle_tpu_torch.ops import vision_ops

from test_torch_ops_library import CASES

GRAD_TOL = 1e-4


def _grads(key, wrt, seed=0):
    """The port's and the JAX op's gradients of ``sum(out * cot)`` for
    the case ``key``, in the arguments ``wrt`` (positions)."""
    case = CASES[key]
    fn = jax_registry.get_op(case.name).fn
    args = list(case.args)
    rs = np.random.RandomState(seed)

    def jax_f(*diff):
        full = list(args)
        for i, d in zip(wrt, diff):
            full[i] = d
        return fn(*[None if a is None else jnp.asarray(a) for a in full],
                  **case.attrs)

    out, vjp = jax.vjp(jax_f, *[jnp.asarray(args[i]) for i in wrt])
    cot = rs.randn(*np.shape(out)).astype(np.float32)
    want = vjp(jnp.asarray(cot))
    t_args = [None if a is None else torch.from_numpy(np.array(a))
              for a in args]
    for i in wrt:
        t_args[i].requires_grad_(True)
    got = call_op(case.name, *t_args, **case.attrs)
    (got * torch.from_numpy(cot)).sum().backward()
    return [t_args[i].grad.numpy() for i in wrt], \
        [np.asarray(w) for w in want]


@pytest.mark.parametrize("key, wrt", [
    ("deform_conv2d", (0, 1, 2, 3, 4)),
    ("yolo_loss", (0,)),
    ("roi_align", (0,)),
    ("roi_pool", (0,)),
    ("psroi_pool", (0,)),
])
def test_gradients_match_jax(key, wrt):
    got, want = _grads(key, wrt)
    for i, g, w in zip(wrt, got, want):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"{key} argument {i}")
        assert np.abs(w).max() > 0, f"{key} argument {i}: zero gradient"


@pytest.mark.parametrize("key", ["roi_align", "roi_pool", "psroi_pool"])
def test_region_ops_in_small_chunks(key, monkeypatch):
    case = CASES[key]
    args = [torch.from_numpy(a) for a in case.args]
    whole = call_op(case.name, *args, **case.attrs)
    monkeypatch.setattr(vision_ops, "_CHUNK_ELEMS", 1)
    np.testing.assert_array_equal(
        call_op(case.name, *args, **case.attrs).numpy(), whole.numpy())
