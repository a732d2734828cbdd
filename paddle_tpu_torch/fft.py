"""``fft`` (counterpart of ``paddle_tpu/fft.py``): the discrete Fourier
transforms over ``torch.fft`` (cuFFT on the card).

``hfftn``/``ihfftn`` (and the 2-D pair) follow scipy, as the JAX
package's own composition does: an FFT over every axis but the last,
then a Hermitian FFT over the last; with ``s`` given and ``axes``
omitted, the last ``len(s)`` axes transform. ``fftfreq``/``rfftfreq``
are float32 (the JAX package ignores ``dtype``) on the current place.
"""
from __future__ import annotations

import torch

from .framework.place import to_torch_device

__all__ = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft",
           "hfft2", "ihfft2", "hfftn", "ihfftn",
           "fft2", "ifft2", "rfft2", "irfft2",
           "fftn", "ifftn", "rfftn", "irfftn",
           "fftfreq", "rfftfreq", "fftshift", "ifftshift"]


def _arr(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _dims(axes):
    return None if axes is None else tuple(axes)


def _wrap1(torch_fn):
    def fn(x, n=None, axis=-1, norm="backward", name=None):
        # ihfft returns a lazily conjugated view: materialise it
        return torch_fn(_arr(x), n=n, dim=axis, norm=norm).resolve_conj()
    fn.__name__ = fn.__qualname__ = torch_fn.__name__
    return fn


def _wrap2(torch_fn):
    def fn(x, s=None, axes=(-2, -1), norm="backward", name=None):
        return torch_fn(_arr(x), s=s, dim=_dims(axes), norm=norm)
    fn.__name__ = fn.__qualname__ = torch_fn.__name__
    return fn


def _wrapn(torch_fn):
    def fn(x, s=None, axes=None, norm="backward", name=None):
        return torch_fn(_arr(x), s=s, dim=_dims(axes), norm=norm)
    fn.__name__ = fn.__qualname__ = getattr(torch_fn, "__name__", "fftn")
    return fn


fft = _wrap1(torch.fft.fft)
ifft = _wrap1(torch.fft.ifft)
rfft = _wrap1(torch.fft.rfft)
irfft = _wrap1(torch.fft.irfft)
hfft = _wrap1(torch.fft.hfft)
ihfft = _wrap1(torch.fft.ihfft)
fft2 = _wrap2(torch.fft.fft2)
ifft2 = _wrap2(torch.fft.ifft2)
rfft2 = _wrap2(torch.fft.rfft2)
irfft2 = _wrap2(torch.fft.irfft2)


def _split_axes(a, s, dim):
    if dim is None:
        dim = tuple(range(a.dim())) if s is None else \
            tuple(range(a.dim() - len(s), a.dim()))
    return tuple(dim)


def _hfftn(a, s=None, dim=None, norm="backward"):
    """hfftn by scipy's rule: an FFT over the leading axes, then a
    Hermitian FFT (real output) over the last."""
    axes = _split_axes(a, s, dim)
    head, last = axes[:-1], axes[-1]
    if head:
        a = torch.fft.fftn(a, s=None if s is None else s[:-1], dim=head,
                           norm=norm)
    n_last = None if s is None else s[-1]
    return torch.fft.hfft(a, n=n_last, dim=last, norm=norm)


def _ihfftn(a, s=None, dim=None, norm="backward"):
    axes = _split_axes(a, s, dim)
    head, last = axes[:-1], axes[-1]
    n_last = None if s is None else s[-1]
    a = torch.fft.ihfft(a, n=n_last, dim=last, norm=norm).resolve_conj()
    if head:
        a = torch.fft.ifftn(a, s=None if s is None else s[:-1], dim=head,
                            norm=norm)
    return a


_hfftn.__name__, _ihfftn.__name__ = "hfftn", "ihfftn"
hfftn = _wrapn(_hfftn)
ihfftn = _wrapn(_ihfftn)


def hfft2(x, s=None, axes=None, norm="backward", name=None):
    """The 2-D :func:`hfftn`; ``axes=None`` is the last two axes (the JAX
    package's ``hfft2`` transforms every axis then: ROADMAP Queue 3)."""
    return _hfftn(_arr(x), s=s, dim=(-2, -1) if axes is None
                  else _dims(axes), norm=norm)


def ihfft2(x, s=None, axes=None, norm="backward", name=None):
    """The 2-D :func:`ihfftn`; ``axes=None`` is the last two axes."""
    return _ihfftn(_arr(x), s=s, dim=(-2, -1) if axes is None
                   else _dims(axes), norm=norm)


fftn = _wrapn(torch.fft.fftn)
ifftn = _wrapn(torch.fft.ifftn)
rfftn = _wrapn(torch.fft.rfftn)
irfftn = _wrapn(torch.fft.irfftn)


def fftfreq(n, d=1.0, dtype=None, name=None):
    return torch.fft.fftfreq(n, d=d, dtype=torch.float32,
                             device=to_torch_device(None))


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return torch.fft.rfftfreq(n, d=d, dtype=torch.float32,
                              device=to_torch_device(None))


def fftshift(x, axes=None, name=None):
    return torch.fft.fftshift(_arr(x), dim=_dims(axes))


def ifftshift(x, axes=None, name=None):
    return torch.fft.ifftshift(_arr(x), dim=_dims(axes))
