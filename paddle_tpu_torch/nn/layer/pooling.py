"""Pooling layers (counterpart of ``paddle_tpu/nn/layer/pooling.py``):
thin wrappers over ``nn.functional``'s pools. ``return_mask=True`` gives
``(pooled, mask)``, the mask flat over the unpadded spatial dims, which
``MaxUnPool*`` reads back."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D", "AdaptiveMaxPool3D",
           "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D"]


class _PoolNd(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 **kw):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self._kw = kw

    def extra_repr(self):
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class MaxPool1D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode)
        self.return_mask = return_mask

    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            return_mask=self.return_mask,
                            ceil_mode=self.ceil_mode)


class MaxPool2D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode)
        self.return_mask = return_mask
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            return_mask=self.return_mask,
                            ceil_mode=self.ceil_mode,
                            data_format=self.data_format)


class MaxPool3D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode)
        self.return_mask = return_mask
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            return_mask=self.return_mask,
                            ceil_mode=self.ceil_mode,
                            data_format=self.data_format)


class AvgPool1D(_PoolNd):
    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode)


class AvgPool2D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode)
        self.exclusive = exclusive
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode,
                            exclusive=self.exclusive,
                            data_format=self.data_format)


class AvgPool3D(_PoolNd):
    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self._output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self._output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._output_size,
                                     self._data_format)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self._output_size,
                                     self._data_format)


class _AdaptiveMaxPoolNd(Layer):
    _fn = None

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self._output_size = output_size
        self._return_mask = return_mask

    def forward(self, x):
        return type(self)._fn(x, self._output_size, self._return_mask)


class AdaptiveMaxPool1D(_AdaptiveMaxPoolNd):
    _fn = staticmethod(F.adaptive_max_pool1d)


class AdaptiveMaxPool2D(_AdaptiveMaxPoolNd):
    _fn = staticmethod(F.adaptive_max_pool2d)


class AdaptiveMaxPool3D(_AdaptiveMaxPoolNd):
    _fn = staticmethod(F.adaptive_max_pool3d)


class _MaxUnPoolNd(Layer):
    _fn = None
    _default_df = None

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format=None, output_size=None, name=None):
        super().__init__()
        self._k, self._s, self._p = kernel_size, stride, padding
        self._output_size = output_size
        self._df = data_format if data_format is not None \
            else type(self)._default_df

    def forward(self, x, indices):
        return type(self)._fn(x, indices, self._k, self._s, self._p,
                              self._df, self._output_size)


class MaxUnPool1D(_MaxUnPoolNd):
    _fn = staticmethod(F.max_unpool1d)
    _default_df = "NCL"


class MaxUnPool2D(_MaxUnPoolNd):
    _fn = staticmethod(F.max_unpool2d)
    _default_df = "NCHW"


class MaxUnPool3D(_MaxUnPoolNd):
    _fn = staticmethod(F.max_unpool3d)
    _default_df = "NCDHW"
