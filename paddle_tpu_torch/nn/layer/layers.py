"""``ParamAttr`` (counterpart of ``paddle_tpu/nn/layer/layers.py:27``):
the per-parameter attributes the optimizer and the clips read.

The JAX package's ``Layer.create_parameter`` sets them on the
``Parameter`` it makes (:159-161), from a layer's ``weight_attr`` and
``bias_attr``. The port's layers are ``torch.nn`` modules, so
:func:`set_param_attr` sets the same attributes on a torch ``Parameter``
that exists already (``Linear`` and ``LayerNorm`` do it for every
parameter they make, as ``create_parameter`` does):

* ``optimize_attr = {"learning_rate": attr.learning_rate}``, the scale
  the optimizer's step puts on its learning rate for this parameter;
* ``need_clip``: ``False`` leaves its gradient out of every clip;
* ``regularizer`` (kept, as in the JAX package, which reads only the
  optimizer's global decay);
* ``requires_grad = attr.trainable``.
"""
from __future__ import annotations

__all__ = ["ParamAttr", "set_param_attr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """A layer's ``weight_attr``/``bias_attr`` as the JAX package reads
        it: ``None`` is the default ``ParamAttr()``, ``False`` no parameter
        (returned as is), a string its name. An initializer (or a
        ``ParamAttr`` holding one) raises: ``nn.initializer`` is not
        ported yet (ROADMAP Queue 1 item 6)."""
        if attr is None:
            return ParamAttr()
        if attr is False:
            return False
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if not isinstance(attr, ParamAttr) or attr.initializer is not None:
            raise NotImplementedError(
                "parameter initializers (nn.initializer) are not ported yet "
                "(ROADMAP Queue 1 item 6)")
        return attr


def set_param_attr(param, attr: ParamAttr):
    """Give the torch ``param`` the attributes of ``attr``; returns it."""
    param.optimize_attr = {"learning_rate": attr.learning_rate}
    param.regularizer = attr.regularizer
    param.need_clip = attr.need_clip
    param.requires_grad_(attr.trainable)
    return param
