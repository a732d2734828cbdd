"""Reference-format ``.pdparams`` checkpoints (counterpart of
``paddle_tpu/utils/pretrained.py``).

The reference's published weights are pickles of ``{structured_name:
ndarray}`` with an optional ``StructuredToParameterName@@`` entry. They
are read by ``framework/io.py``'s :func:`load_pdparams`, whose unpickler
admits numpy arrays and builtin containers only, so a tampered file
cannot run code. The port's layers keep the reference's structured names
(BatchNorm's ``_mean``/``_variance`` included) and its OIHW convolution
weights, so one file serves the NCHW and NHWC models; only ``Linear``
weights are stored ``[out, in]`` here and are transposed on the way in.

Nothing downloads: ``pretrained=True`` resolves the model's published
file name in the local weights cache (``utils.download``), and a model's
``pretrained=`` also takes a path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.io import load_pdparams

__all__ = ["load_pdparams", "load_pretrained"]


def _squeezed(shape):
    return tuple(d for d in shape if d != 1)


def convert_state_dict(raw: dict, model) -> dict:
    """``raw`` (``{name: array}``) aligned to ``model``'s state dict: its
    keys only, each in the port's layout (``Linear`` weights ``[out,
    in]``) and its tensor's dtype, on the CPU. A missing key raises; a
    shape that differs other than by dimensions of 1 raises (a same-size
    reshape would load a transposed matrix as garbage)."""
    from ..convert import _linear_keys

    target = model.state_dict()
    missing = [k for k in target if k not in raw]
    if missing:
        raise ValueError(
            f"checkpoint is missing {len(missing)} keys, e.g. "
            f"{missing[:5]}: architecture mismatch?")
    linear = _linear_keys(model)
    out = {}
    for k, t in target.items():
        arr = raw[k]
        arr = arr.detach().cpu() if isinstance(arr, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(arr))
        if k in linear:
            arr = arr.t()
        if tuple(arr.shape) != tuple(t.shape):
            if _squeezed(arr.shape) != _squeezed(t.shape):
                raise ValueError(
                    f"shape mismatch for {k}: checkpoint "
                    f"{tuple(arr.shape)} vs model {tuple(t.shape)}")
            arr = arr.reshape(tuple(t.shape))
        out[k] = arr.to(t.dtype).contiguous()
    return out


def load_pretrained(model, arch: str, model_urls: dict, pretrained):
    """The model zoo's ``pretrained=``: a ``.pdparams`` path, or ``True``
    for ``model_urls[arch]``'s file in the local weights cache (the
    reference's ``get_weights_path_from_url``). Loads it into ``model``
    and returns ``model``."""
    if isinstance(pretrained, str):
        path = pretrained
    else:
        if arch not in model_urls:
            raise ValueError(
                f"{arch} has no pretrained weights; set pretrained=False "
                f"or pass a .pdparams path")
        from .download import get_weights_path_from_url
        url, md5 = model_urls[arch]
        path = get_weights_path_from_url(url, md5)
    model.set_state_dict(convert_state_dict(load_pdparams(path), model))
    return model
