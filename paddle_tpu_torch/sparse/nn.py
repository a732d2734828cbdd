"""``sparse.nn`` (counterpart of ``paddle_tpu/sparse/nn.py``): sparse
conv3d, pooling and norm over NDHWC sparse tensors with DHWIO weights.

As in the JAX package, compute runs dense (one ``F.conv3d`` or
``F.max_pool3d`` over the densified block, cuDNN on the card, the
layouts permuted to NCDHW/OIDHW around it) and the sparsity lives in the
output pattern:

* ``subm_conv3d`` keeps the input's pattern (stride 1, shape-preserving
  padding): dense conv, then a gather at the stored sites;
* ``conv3d`` and ``max_pool3d`` take as output sites every site a
  kernel window reaches from an active one, read off a count conv (a
  max pool) over the occupancy, not off the values: a reached site whose
  value is 0 stays a site;
* ``batch_norm`` normalises the ``nnz x C`` value matrix.

The values keep their autograd graph, so the weights train.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ..nn.layer.layers import Layer
from . import SparseCooTensor

__all__ = ["conv3d", "subm_conv3d", "max_pool3d", "relu", "batch_norm",
           "Conv3D", "SubmConv3D", "MaxPool3D", "ReLU", "BatchNorm"]


def _norm3(v):
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def _dense_ndhwc(x: SparseCooTensor):
    if not isinstance(x, SparseCooTensor):
        raise TypeError(f"expected SparseCooTensor, got {type(x).__name__}")
    if len(x.shape) != 5:
        raise ValueError(
            f"sparse conv3d expects a 5-D NDHWC tensor, got {x.shape}")
    return x.to_dense()


def _w(weight, like):
    w = weight if isinstance(weight, torch.Tensor) else torch.as_tensor(
        weight)
    return w.to(device=like.device, dtype=like.dtype)


def _conv3d_dense(dense, weight, bias, stride, padding, dilation, groups):
    """NDHWC x DHWIO -> NDHWC."""
    if weight.dim() != 5:
        raise ValueError(
            f"weight must be DHWIO (5-D), got shape {tuple(weight.shape)}")
    out = TF.conv3d(dense.permute(0, 4, 1, 2, 3),
                    weight.permute(4, 3, 0, 1, 2), None, _norm3(stride),
                    _norm3(padding), _norm3(dilation), int(groups))
    out = out.permute(0, 2, 3, 4, 1)
    return out if bias is None else out + bias


def _sparsify(dense, site_mask) -> SparseCooTensor:
    """The sites of ``site_mask`` (``[N, D, H, W]``) with their channel
    vectors: an explicit reachability mask, so that a reached site whose
    value is exactly 0 stays in the pattern."""
    idx = torch.nonzero(site_mask)                   # [nnz, 4] row-major
    vals = dense[tuple(idx.t())]                     # [nnz, C]
    return SparseCooTensor((idx.t().contiguous(), vals, tuple(dense.shape)))


def _occupancy(x: SparseCooTensor):
    """Bool ``[N, D, H, W]``: the active sites of a 5-D sparse tensor."""
    occ = torch.zeros(tuple(x.shape[:-1]), dtype=torch.bool,
                      device=x._values.device)
    occ[tuple(x._indices)] = True
    return occ


def conv3d(x: SparseCooTensor, weight, bias=None, stride=1, padding=0,
           dilation=1, groups=1, data_format="NDHWC") -> SparseCooTensor:
    """Sparse conv3d: the output sites are every site a kernel window
    reaches from an active input site."""
    if data_format != "NDHWC":
        raise ValueError("sparse conv3d supports NDHWC only (the "
                         "reference's layout)")
    dense = _dense_ndhwc(x)
    w = _w(weight, dense)
    b = None if bias is None else _w(bias, dense)
    out = _conv3d_dense(dense, w, b, stride, padding, dilation, groups)
    with torch.no_grad():
        occ = _occupancy(x).to(dense.dtype)[..., None]
        ones = torch.ones(tuple(w.shape[:3]) + (1, 1), dtype=dense.dtype,
                          device=dense.device)
        reached = _conv3d_dense(occ, ones, None, stride, padding,
                                dilation, 1)[..., 0] > 0
    return _sparsify(out, reached)


def subm_conv3d(x: SparseCooTensor, weight, bias=None, stride=1,
                padding=0, dilation=1, groups=1,
                data_format="NDHWC") -> SparseCooTensor:
    """Submanifold sparse conv3d: the output pattern is the input's
    (stride 1 and shape-preserving padding required)."""
    if data_format != "NDHWC":
        raise ValueError("subm_conv3d supports NDHWC only")
    if _norm3(stride) != (1, 1, 1):
        raise ValueError("subm_conv3d requires stride=1 (the submanifold "
                         "pattern is only shape-preserving at stride 1)")
    w_shape = tuple(weight.shape)
    for k, p, d in zip(w_shape[:3], _norm3(padding), _norm3(dilation)):
        if 2 * p != (int(k) - 1) * d:
            raise ValueError(
                f"subm_conv3d needs shape-preserving padding: kernel "
                f"{tuple(int(v) for v in w_shape[:3])} with padding "
                f"{_norm3(padding)} dilation {_norm3(dilation)} changes "
                f"the spatial shape, so input-site indexing would read "
                f"out of bounds; use padding=(k-1)*dilation/2 per axis")
    dense = _dense_ndhwc(x)
    w = _w(weight, dense)
    b = None if bias is None else _w(bias, dense)
    out = _conv3d_dense(dense, w, b, stride, padding, dilation, groups)
    vals = out[tuple(x._indices)]
    return SparseCooTensor((x._indices, vals, tuple(x.shape[:-1])
                            + (int(vals.shape[-1]),)))


def max_pool3d(x: SparseCooTensor, kernel_size, stride=None, padding=0,
               data_format="NDHWC") -> SparseCooTensor:
    """Sparse max pooling: the max over the active sites of each window;
    a window with no active site gives no output site."""
    if data_format != "NDHWC":
        raise ValueError("sparse max_pool3d supports NDHWC only")
    dense = _dense_ndhwc(x)
    k = _norm3(kernel_size)
    s = _norm3(stride) if stride is not None else k
    p = _norm3(padding)
    occ = _occupancy(x)[..., None]
    # only active sites compete: an all-negative active site must still
    # win over the inactive zeros
    masked = torch.where(occ, dense, torch.full_like(dense, -torch.inf))
    pooled = TF.max_pool3d(masked.permute(0, 4, 1, 2, 3), k, s, p)
    pooled = pooled.permute(0, 2, 3, 4, 1)
    with torch.no_grad():
        any_active = TF.max_pool3d(
            occ.to(dense.dtype).permute(0, 4, 1, 2, 3), k, s, p).permute(
                0, 2, 3, 4, 1) > 0
    pooled = torch.where(any_active, pooled, torch.zeros_like(pooled))
    return _sparsify(pooled, any_active[..., 0])


def relu(x: SparseCooTensor) -> SparseCooTensor:
    from . import relu as _relu
    return _relu(x)


def batch_norm(x: SparseCooTensor, mean, variance, weight, bias,
               epsilon=1e-5) -> SparseCooTensor:
    """A per-channel affine norm of the values (the active sites)."""
    vals = x._values

    def arr(v):
        return _w(v, vals)

    y = (vals - arr(mean)) / torch.sqrt(arr(variance) + epsilon) \
        * arr(weight) + arr(bias)
    return SparseCooTensor((x._indices, y, x._shape))


class _SparseConvBase(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias_attr=None,
                 data_format="NDHWC"):
        super().__init__()
        k = _norm3(kernel_size)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        # DHWIO, the sparse conv weight layout
        self.weight = self.create_parameter(
            list(k) + [in_channels // groups, out_channels], is_bias=False)
        self.bias = None if bias_attr is False else \
            self.create_parameter([out_channels], is_bias=True)


class Conv3D(_SparseConvBase):
    def forward(self, x):
        return conv3d(x, self.weight, self.bias, self._stride,
                      self._padding, self._dilation, self._groups,
                      self._data_format)


class SubmConv3D(_SparseConvBase):
    def forward(self, x):
        return subm_conv3d(x, self.weight, self.bias, self._stride,
                           self._padding, self._dilation, self._groups,
                           self._data_format)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NDHWC"):
        super().__init__()
        self._kernel_size = kernel_size
        self._stride = stride
        self._padding = padding
        self._data_format = data_format

    def forward(self, x):
        return max_pool3d(x, self._kernel_size, self._stride,
                          self._padding, self._data_format)


class ReLU(Layer):
    def forward(self, x):
        return relu(x)


class BatchNorm(Layer):
    """Sparse BatchNorm over the values: per-channel running statistics
    over the active sites only."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5):
        super().__init__()
        from ..nn.initializer import Constant
        self._momentum, self._epsilon = momentum, epsilon
        self.weight = self.create_parameter(
            [num_features], is_bias=False, default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_features], is_bias=True)
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x: SparseCooTensor):
        vals = x._values
        if self.training:
            with torch.no_grad():
                mean = vals.mean(dim=0)
                var = vals.var(dim=0, unbiased=False)
                m = self._momentum
                self._mean = (m * self._mean + (1 - m) * mean).float()
                self._variance = (m * self._variance
                                  + (1 - m) * var).float()
        else:
            mean, var = self._mean, self._variance
        return batch_norm(x, mean, var, self.weight, self.bias,
                          self._epsilon)
