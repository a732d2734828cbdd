"""The port's ``extra_nn_ops`` against the JAX package's on the CPU.

* Every case of the 22 ops in ``paddle_tpu_torch.ops.op_cases`` (several
  for the ops whose attributes choose another path: layouts, string
  paddings, groups, ``ceil_mode``, the grid sampler's modes, custom
  trees), as ``test_torch_ops_library.py`` holds the rest of the library:
  floats within atol 1e-5 + rtol 1e-5, indices and integers exactly and
  with the JAX op's dtype (the pooling mask int32, ``class_center_sample``
  int64), ``class_center_sample`` by its rule.
* The gradient of every differentiable case: in
  ``test_torch_extra_nn_grads.py``.
* ``nn.functional.ctc_loss``'s reductions and ``norm_by_times`` and its
  gradient, held against the JAX function (not torch's CTC loss, whose
  ``"mean"`` and blank rules differ).
* The pooling mask's convention: flat over the unpadded spatial dims,
  read back by ``max_unpool*`` (the round trip restores every window's
  maximum in place).
* ``class_center_sample`` in distribution: over many draws each negative
  class is drawn as often as a uniform choice without replacement draws
  it (within 5 standard errors).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.framework.dispatch import call_op
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import op_cases
from test_torch_ops_library import (ATOL, CASES, EXTRA_NN, RTOL,
                                    check_against_jax)

KEYS = sorted(k for k, c in CASES.items() if c.name in EXTRA_NN)


def test_every_extra_nn_op_has_a_case():
    assert {CASES[k].name for k in KEYS} == set(EXTRA_NN)


@pytest.mark.parametrize("key", KEYS)
def test_op_matches_the_jax_op(key):
    check_against_jax(key)


def _ctc_inputs():
    rs = np.random.RandomState(3)
    return (rs.randn(8, 3, 6).astype(np.float32),
            np.array([[1, 2, 2, 5], [3, 1, 0, 0], [4, 4, 1, 3]], np.int32),
            np.array([8, 6, 5], np.int64), np.array([4, 2, 3], np.int64))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("norm_by_times", [False, True])
def test_ctc_loss_reductions_match_the_jax_function(reduction,
                                                    norm_by_times):
    lp, labels, in_len, lab_len = _ctc_inputs()
    x = torch.tensor(lp, requires_grad=True)
    got = TF.ctc_loss(x, torch.from_numpy(labels), torch.from_numpy(in_len),
                      torch.from_numpy(lab_len), blank=0,
                      reduction=reduction, norm_by_times=norm_by_times)
    jx = paddle.to_tensor(lp, stop_gradient=False)
    want = JF.ctc_loss(jx, paddle.to_tensor(labels), paddle.to_tensor(in_len),
                       paddle.to_tensor(lab_len), blank=0,
                       reduction=reduction, norm_by_times=norm_by_times)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               atol=ATOL, rtol=RTOL)
    got.sum().backward()
    paddle.sum(want).backward()
    np.testing.assert_allclose(x.grad.numpy(), jx.grad.numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_the_mask_is_flat_over_the_unpadded_dims_and_unpools(nd):
    """``max_pool{nd}d(return_mask=True)`` then ``max_unpool{nd}d``: the
    mask indexes the input flattened over its spatial dims, equal to the
    JAX mask; unpooling puts each maximum back where it was (zeros
    elsewhere), as the JAX chain does."""
    rs = np.random.RandomState(nd)
    x = rs.randn(*((2, 3) + (6,) * nd)).astype(np.float32)
    pool = getattr(TF, f"max_pool{nd}d")
    unpool = getattr(TF, f"max_unpool{nd}d")
    out, mask = pool(torch.from_numpy(x), 2, stride=2, padding=1,
                     return_mask=True)
    j_out, j_mask = getattr(JF, f"max_pool{nd}d")(
        paddle.to_tensor(x), 2, stride=2, padding=1, return_mask=True)
    assert mask.dtype == torch.int32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask.numpy()))
    flat = x.reshape(2, 3, -1)
    np.testing.assert_array_equal(
        np.take_along_axis(flat, mask.numpy().reshape(2, 3, -1).astype(
            np.int64), axis=2).reshape(out.shape), out.numpy())
    back = unpool(out, mask, 2, stride=2, padding=1,
                  output_size=x.shape).numpy()
    j_back = getattr(JF, f"max_unpool{nd}d")(
        j_out, j_mask, 2, stride=2, padding=1, output_size=x.shape).numpy()
    np.testing.assert_array_equal(back, j_back)
    kept = back != 0
    np.testing.assert_array_equal(back[kept], x[kept])


def test_adaptive_max_pool_mask_matches_the_jax_function():
    x = np.random.RandomState(5).randn(2, 3, 6, 4).astype(np.float32)
    out, mask = TF.adaptive_max_pool2d(torch.from_numpy(x), (3, 2),
                                       return_mask=True)
    j_out, j_mask = JF.adaptive_max_pool2d(paddle.to_tensor(x), (3, 2),
                                           return_mask=True)
    np.testing.assert_array_equal(out.numpy(), j_out.numpy())
    np.testing.assert_array_equal(mask.numpy(), j_mask.numpy())
    with pytest.raises(NotImplementedError, match="dividing"):
        TF.adaptive_max_pool2d(torch.from_numpy(x), (4, 3), return_mask=True)


def test_class_center_sample_draws_negatives_uniformly():
    label = torch.tensor([3, 7, 7, 12, 3, 0])
    n_classes, n_samples, draws = 20, 8, 2000
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(n_classes)
    for _ in range(draws):
        remapped, sampled = call_op("class_center_sample", label, n_classes,
                                    n_samples, generator=gen)
        counts[sampled.numpy()] += 1
        assert torch.equal(sampled[remapped], label)
    positives = [0, 3, 7, 12]
    assert (counts[positives] == draws).all()
    p = (n_samples - len(positives)) / (n_classes - len(positives))
    negatives = np.delete(counts, positives) / draws
    sem = np.sqrt(p * (1 - p) / draws)
    assert np.abs(negatives - p).max() <= 5 * sem, negatives
    # a seed repeats its draw; positives beyond num_samples are all kept
    a = call_op("class_center_sample", label, n_classes, n_samples, seed=4)
    b = call_op("class_center_sample", label, n_classes, n_samples, seed=4)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    _, few = call_op("class_center_sample", label, n_classes, 2)
    assert few.tolist() == positives


def test_the_functional_wrappers_match_the_jax_functions():
    """The wrappers whose arguments the op does not see as they are:
    ``affine_grid``'s tensor ``out_shape``, the transposed convolutions'
    ``output_size``, ``margin_cross_entropy``'s reduction with
    ``return_softmax``."""
    rs = np.random.RandomState(11)
    theta = rs.randn(2, 2, 3).astype(np.float32)
    np.testing.assert_allclose(
        TF.affine_grid(torch.from_numpy(theta), torch.tensor([2, 3, 4, 5]),
                       align_corners=False).numpy(),
        JF.affine_grid(paddle.to_tensor(theta), [2, 3, 4, 5],
                       align_corners=False).numpy(), atol=ATOL, rtol=RTOL)
    x, w = rs.randn(2, 4, 5).astype(np.float32), \
        rs.randn(4, 3, 3).astype(np.float32)
    np.testing.assert_allclose(
        TF.conv1d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                            stride=2, padding=1, output_size=[10]).numpy(),
        JF.conv1d_transpose(paddle.to_tensor(x), paddle.to_tensor(w),
                            stride=2, padding=1, output_size=[10]).numpy(),
        atol=ATOL, rtol=RTOL)
    x3, w3 = rs.randn(1, 2, 3, 3, 3).astype(np.float32), \
        rs.randn(2, 2, 2, 2, 2).astype(np.float32)
    got = TF.conv3d_transpose(torch.from_numpy(x3), torch.from_numpy(w3),
                              stride=2, output_size=[7, 7, 7])
    want = JF.conv3d_transpose(paddle.to_tensor(x3), paddle.to_tensor(w3),
                               stride=2, output_size=[7, 7, 7])
    assert got.shape == (1, 2, 7, 7, 7)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)
    cos = rs.uniform(-0.9, 0.9, (4, 6)).astype(np.float32)
    lab = np.array([1, 0, 5, 2], np.int64)
    for red in ("mean", "sum", "none"):
        loss, soft = TF.margin_cross_entropy(
            torch.from_numpy(cos), torch.from_numpy(lab), scale=8.0,
            return_softmax=True, reduction=red)
        j_loss, j_soft = JF.margin_cross_entropy(
            paddle.to_tensor(cos), paddle.to_tensor(lab), scale=8.0,
            return_softmax=True, reduction=red)
        np.testing.assert_allclose(loss.numpy(), j_loss.numpy(), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(soft.numpy(), j_soft.numpy(), atol=ATOL,
                                   rtol=RTOL)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        TF.class_center_sample(torch.from_numpy(lab), 6, 4, group=object())


def test_sparse_attention_on_a_full_pattern_is_dense_attention():
    """With every (row, column) in the pattern, CSR attention is plain
    softmax attention (the ``scaled_dot_product_attention`` op, whose
    layout is ``[B, S, H, D]``)."""
    rs = np.random.RandomState(13)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 5, 8).astype(np.float32))
               for _ in range(3))
    offset = torch.arange(0, 26, 5, dtype=torch.int32).expand(1, 2, 6)
    columns = torch.arange(5, dtype=torch.int32).repeat(5).expand(1, 2, 25)
    got = TF.sparse_attention(q, k, v, offset, columns)
    want = call_op("scaled_dot_product_attention", q.transpose(1, 2),
                   k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert op_cases.to_numpy_tree(got).shape == (1, 2, 5, 8)
