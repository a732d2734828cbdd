"""Fluid-style ``static.nn`` layer builders (counterpart of
``paddle_tpu/static/nn/layers_compat.py``).

Reference: python/paddle/static/nn/__init__.py re-exporting
fluid/layers/nn.py: functional builders that create parameters at the
call site and append ops to the current program. Each builder makes the
matching ``nn`` layer on its input's device (its parameters enter the
recorded program at their first use) and applies it. The layer cache
follows fluid's unique names: an unnamed builder makes fresh parameters
at every call, and ``name=`` shares one set across calls
(``fc_compat_registry``).

The sequence builders work on the dense ``(padded, lengths)`` encoding
of the port's ``sequence_ops``: ``lengths`` is an optional keyword
everywhere; without it every row counts as full length.

Two builders wait on other ROADMAP items and raise naming them:
``sparse_embedding`` (a ``distributed.embedding`` table, Queue 1 item
4) and ``deform_conv2d`` (``vision.ops``, item 5, step 4).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...framework import static_capture as _capture
from ...ops.registry import not_ported as _not_ported

__all__ = [
    "fc_compat_registry",  # introspection/testing
    "embedding", "sparse_embedding", "conv2d", "conv3d",
    "conv2d_transpose", "conv3d_transpose", "batch_norm", "layer_norm",
    "instance_norm", "group_norm", "spectral_norm", "data_norm", "prelu",
    "bilinear_tensor_product", "deform_conv2d", "row_conv", "nce",
    "crf_decoding", "multi_box_head", "StaticRNN",
    "sequence_concat", "sequence_conv", "sequence_enumerate",
    "sequence_expand", "sequence_expand_as", "sequence_first_step",
    "sequence_last_step", "sequence_pad", "sequence_pool",
    "sequence_reshape", "sequence_reverse", "sequence_scatter",
    "sequence_slice", "sequence_softmax", "sequence_unpad",
]

# call-site layer cache (fluid's unique_name equivalent): one parameter
# set per name/config across repeated build executions
_LAYERS: Dict[tuple, object] = {}
fc_compat_registry = _LAYERS


def _cached(key, factory, name=None):
    """fluid unique_name semantics: an UNNAMED builder creates FRESH
    parameters on every call (fluid increments fc_0, fc_1, ... even in a
    Python loop over one source line); only an explicit ``name=`` shares
    a parameter set across calls."""
    if name is None:
        return factory()
    layer = _LAYERS.get(key)
    if layer is None:
        layer = factory()
        _LAYERS[key] = layer
    return layer


def _pkg_nn():
    from ... import nn
    return nn


def _on(like, factory):
    """``factory`` whose layer is made and moved to ``like``'s device
    outside the recording (a layer's construction is not part of the
    program)."""
    def make():
        with _capture.paused():
            return factory().to(like.device)
    return make


def _param(array, like):
    """A parameter holding the numpy ``array`` on ``like``'s device."""
    with _capture.paused():
        return torch.nn.Parameter(torch.from_numpy(
            np.ascontiguousarray(array)).to(like.device))


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32", name=None):
    nn = _pkg_nn()
    layer = _cached(("embedding", name, tuple(size), padding_idx),
                    _on(input, lambda: nn.Embedding(
                        size[0], size[1], padding_idx=padding_idx,
                        weight_attr=param_attr)),
                    name=name)
    return layer(input)


def sparse_embedding(input, size, padding_idx=None, param_attr=None,
                     is_test=False, entry=None, table_class=None,
                     dtype="float32", name=None):
    """The reference feeds the PS sparse table; the JAX package a
    mesh-sharded table (``distributed.embedding``), multi-device work."""
    raise _not_ported("static.nn.sparse_embedding (a distributed."
                      "embedding table)", 4)


def _conv(nd, transpose, input, num_filters, filter_size, stride=1,
          padding=0, dilation=1, groups=1, param_attr=None,
          bias_attr=None, data_format=None, name=None, act=None,
          output_size=None, **kwargs):
    if kwargs:
        raise TypeError(f"unsupported conv argument(s) {sorted(kwargs)}; "
                        f"silently ignoring fluid knobs would change the "
                        f"computed network")
    nn = _pkg_nn()
    df = data_format or ("NCHW" if nd == 2 else "NCDHW")
    in_c = int(input.shape[1] if df.startswith("NC")
               else input.shape[-1])
    if transpose and filter_size is None:
        if output_size is None:
            raise ValueError("conv transpose needs filter_size= or "
                             "output_size=")
        # reference semantics: derive the kernel so stride x input +
        # kernel - stride == output (padding 0)
        in_sp = (input.shape[2:2 + nd] if df.startswith("NC")
                 else input.shape[1:1 + nd])
        outs = np.atleast_1d(output_size)
        st = np.broadcast_to(np.atleast_1d(stride), (nd,))
        filter_size = tuple(int(o - (int(i) - 1) * int(s))
                            for o, i, s in zip(outs, in_sp, st))
    cls = {(2, False): nn.Conv2D, (3, False): nn.Conv3D,
           (2, True): nn.Conv2DTranspose, (3, True): nn.Conv3DTranspose}[
        (nd, transpose)]
    layer = _cached(
        ("conv", nd, transpose, name, in_c, num_filters,
         tuple(np.atleast_1d(filter_size)), tuple(np.atleast_1d(stride)),
         tuple(np.atleast_1d(padding)), tuple(np.atleast_1d(dilation)),
         groups, df),
        _on(input, lambda: cls(in_c, num_filters, filter_size,
                               stride=stride, padding=padding,
                               dilation=dilation, groups=groups,
                               weight_attr=param_attr, bias_attr=bias_attr,
                               data_format=df)),
        name=name)
    out = layer(input, output_size=output_size) if transpose and \
        output_size is not None else layer(input)
    return _act(out, act)


def conv2d(input, num_filters, filter_size, **kwargs):
    return _conv(2, False, input, num_filters, filter_size, **kwargs)


def conv3d(input, num_filters, filter_size, **kwargs):
    return _conv(3, False, input, num_filters, filter_size, **kwargs)


def conv2d_transpose(input, num_filters, filter_size=None, **kwargs):
    return _conv(2, True, input, num_filters, filter_size, **kwargs)


def conv3d_transpose(input, num_filters, filter_size=None, **kwargs):
    return _conv(3, True, input, num_filters, filter_size, **kwargs)


def batch_norm(input, act=None, is_test=False, momentum=0.9,
               epsilon=1e-5, param_attr=None, bias_attr=None,
               data_layout="NCHW", name=None, **kwargs):
    nn = _pkg_nn()
    c = int(input.shape[1] if data_layout.startswith("NC")
            else input.shape[-1])
    rank = len(input.shape)
    if rank == 5:
        df5 = "NCDHW" if data_layout.startswith("NC") else "NDHWC"
        factory = lambda: nn.BatchNorm3D(c, momentum=momentum,  # noqa: E731
                                         epsilon=epsilon, data_format=df5)
    elif rank == 4:
        factory = lambda: nn.BatchNorm2D(c, momentum=momentum,  # noqa: E731
                                         epsilon=epsilon,
                                         data_format=data_layout)
    else:
        df1 = "NCL" if data_layout.startswith("NC") else "NLC"
        factory = lambda: nn.BatchNorm1D(c, momentum=momentum,  # noqa: E731
                                         epsilon=epsilon, data_format=df1)
    layer = _cached(("batch_norm", name, c, data_layout, rank),
                    _on(input, factory), name=name)
    return _act(layer(input), act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    """LayerNorm over the axes from ``begin_norm_axis`` on. The port's
    ``LayerNorm`` normalizes the last axis (its kernels do), so several
    normalized axes are flattened into one around it: the same values,
    with the affine parameters ``[prod(shape)]`` where the JAX layer's
    are ``shape``."""
    nn = _pkg_nn()
    shape = tuple(int(s) for s in input.shape[begin_norm_axis:])
    width = int(np.prod(shape))
    layer = _cached(("layer_norm", name, shape),
                    _on(input, lambda: nn.LayerNorm(width, epsilon=epsilon)),
                    name=name)
    if len(shape) == 1:
        return _act(layer(input), act)
    lead = [-1] + [int(s) for s in input.shape[1:begin_norm_axis]]
    out = layer(input.reshape(lead + [width]))
    return _act(out.reshape([-1] + list(input.shape[1:])), act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    nn = _pkg_nn()
    c = int(input.shape[1])
    layer = _cached(("instance_norm", name, c),
                    _on(input, lambda: nn.InstanceNorm2D(c,
                                                         epsilon=epsilon)),
                    name=name)
    return layer(input)


def group_norm(input, groups, epsilon=1e-5, param_attr=None,
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    nn = _pkg_nn()
    c = int(input.shape[1])
    layer = _cached(("group_norm", name, c, groups),
                    _on(input, lambda: nn.GroupNorm(groups, c,
                                                    epsilon=epsilon)),
                    name=name)
    return _act(layer(input), act)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """Functional spectral normalization of a weight VAR (reference fluid
    spectral_norm op) through the ``spectral_norm`` op, so that it
    records into programs. The reference keeps weight_u/v across steps
    so that power_iters=1 converges over training; this one-shot form
    runs at least 10 iterations, as the JAX package's."""
    from ...framework.dispatch import call_op
    h = int(weight.shape[dim])
    rest = int(np.prod(weight.shape)) // h
    rng = np.random.RandomState(0)
    u0 = torch.from_numpy(rng.randn(h).astype(np.float32)).to(weight.device)
    v0 = torch.from_numpy(rng.randn(rest).astype(np.float32)).to(
        weight.device)
    return call_op("spectral_norm", weight, u0, v0, dim=dim,
                   power_iters=max(int(power_iters), 10), eps=eps)


def _data_norm_layer(c, epsilon):
    nn = _pkg_nn()

    class _DataNorm(nn.Layer):
        """Normalize by accumulated batch statistics, without scale or
        shift (the CTR stack's feature normalizer): running mean and
        variance buffers blended with momentum 0.9 in training."""

        def __init__(self):
            super().__init__()
            self.register_buffer("_mean", torch.zeros(c))
            self.register_buffer("_var", torch.ones(c))

        def forward(self, x):
            if self.training:
                mean = x.mean(dim=0)
                var = x.var(dim=0, unbiased=False)
                with torch.no_grad():
                    m = 0.9
                    # the buffers hold running statistics, not the last
                    # batch's; written outside the recorded ops, as BN
                    self._mean.data = m * self._mean + (1 - m) * mean
                    self._var.data = m * self._var + (1 - m) * var
            else:
                mean, var = self._mean, self._var
            return (x - mean) / torch.sqrt(var + epsilon)

    return _DataNorm()


def data_norm(input, epsilon=1e-5, param_attr=None, name=None, **kwargs):
    """Reference data_norm, the dense form (see ``_DataNorm``)."""
    c = int(input.shape[-1])
    layer = _cached(("data_norm", name, c),
                    _on(input, lambda: _data_norm_layer(c, epsilon)),
                    name=name)
    return layer(input)


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    nn = _pkg_nn()
    if mode == "all":
        num = 1
    elif mode == "channel":
        num = int(x.shape[1] if data_format.startswith("NC")
                  else x.shape[-1])
    else:
        raise NotImplementedError(
            "prelu mode='element' (per-element alphas) is not provided; "
            "use mode='channel' or nn.PReLU directly")
    layer = _cached(("prelu", name, mode, num),
                    _on(x, lambda: nn.PReLU(num_parameters=num,
                                            weight_attr=param_attr)),
                    name=name)
    return layer(x)


def bilinear_tensor_product(x, y, size, act=None, param_attr=None,
                            bias_attr=None, name=None):
    nn = _pkg_nn()
    layer = _cached(("bilinear", name, int(x.shape[-1]),
                     int(y.shape[-1]), size),
                    _on(x, lambda: nn.Bilinear(int(x.shape[-1]),
                                               int(y.shape[-1]), size,
                                               weight_attr=param_attr,
                                               bias_attr=bias_attr)),
                    name=name)
    return _act(layer(x, y), act)


def deform_conv2d(x, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1,
                  deformable_groups=1, im2col_step=1, param_attr=None,
                  bias_attr=None, name=None):
    """Over ``vision.ops.DeformConv2D``, which the port has not yet."""
    raise _not_ported("static.nn.deform_conv2d (vision.ops, step 4)", 5)


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    """Lookahead row convolution (reference row_conv op, DeepSpeech2)
    through the ``row_conv`` op (records into programs)."""
    from ...framework.dispatch import call_op
    d = int(input.shape[-1])
    k = int(future_context_size) + 1
    w = _cached(("row_conv", name, d, k),
                lambda: _param(np.full((k, d), 1.0 / k, np.float32), input),
                name=name)
    return _act(call_op("row_conv", input, w), act)


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation loss (reference nce op): the logistic
    loss of the true class and of k uniform negative samples, through the
    ``nce_loss`` op, so that in a program the LABEL is a recorded input
    (feeds flow at replay). The negative ids are drawn once per call
    (fixed for a program; drawn again at each eager call) from the
    port's generator of the input's device."""
    from ...framework.dispatch import call_op
    from ...framework.random import get_generator
    d = int(input.shape[-1])
    k = int(num_neg_samples or 5)
    w, b = _cached(
        ("nce", name, num_total_classes, d),
        lambda: (_param((np.random.RandomState(seed)
                         .randn(num_total_classes, d) / np.sqrt(d))
                        .astype(np.float32), input),
                 _param(np.zeros((num_total_classes,), np.float32), input)),
        name=name)
    n_rows = int(label.shape[0])
    neg = torch.randint(0, num_total_classes, (n_rows, k),
                        generator=get_generator(input.device),
                        device=input.device)
    return call_op("nce_loss", input, label, w, b, neg)


def crf_decoding(input, param_attr=None, label=None, length=None):
    """Viterbi decode over emissions with a learned transition matrix
    (reference crf_decoding op; ``text.viterbi_decode`` is the
    engine)."""
    from ...text import viterbi_decode
    n = int(input.shape[-1])
    trans = _cached(("crf_transition", "crfw", n),
                    lambda: _param(np.zeros((n + 2, n), np.float32), input),
                    name="crfw")
    lengths = length if length is not None else torch.full(
        (input.shape[0],), input.shape[1], dtype=torch.int64,
        device=input.device)
    # body transitions only (the reference keeps start/stop rows extra)
    _, path = viterbi_decode(input, trans[2:].detach(), lengths)
    return path


def multi_box_head(*args, **kwargs):
    raise NotImplementedError(
        "multi_box_head (SSD prior-box head) is not provided as a fluid "
        "builder; compose paddle.vision.ops detection primitives "
        "(yolo_box/nms/RoI ops) or a model-zoo detector instead")


def _act(out, act):
    if act is None:
        return out
    from ...nn import functional as F
    return getattr(F, act)(out)


# --------------------------------------------------------------------------
# sequence builders over the dense (padded, lengths) encoding
# --------------------------------------------------------------------------

def _full_lengths(x):
    return torch.full((x.shape[0],), x.shape[1], dtype=torch.int64,
                      device=x.device)


def _seq(fname, x, lengths=None, **kwargs):
    from ...nn import functional as F
    return getattr(F, fname)(x, lengths if lengths is not None
                             else _full_lengths(x), **kwargs)


def sequence_pool(input, pool_type, lengths=None, is_test=False,
                  pad_value=0.0):
    return _seq("sequence_pool", input, lengths, pool_type=pool_type)


def sequence_softmax(input, lengths=None, use_cudnn=False, name=None):
    return _seq("sequence_softmax", input, lengths)


def sequence_reverse(x, lengths=None, name=None):
    return _seq("sequence_reverse", x, lengths)


def sequence_first_step(input, lengths=None):
    return sequence_pool(input, "first", lengths)


def sequence_last_step(input, lengths=None):
    return sequence_pool(input, "last", lengths)


def sequence_conv(input, num_filters, filter_size=3, lengths=None,
                  filter_stride=1, padding=True, padding_start=None,
                  param_attr=None, bias_attr=None, act=None, name=None):
    from ...framework.dispatch import call_op
    if filter_stride != 1 or padding_start is not None:
        raise NotImplementedError(
            "sequence_conv supports filter_stride=1 with centered "
            "padding (the common configuration); other strides/starts "
            "would silently change the computation")
    d = int(input.shape[-1])
    w, b = _cached(
        ("sequence_conv", name, d, num_filters, filter_size,
         bias_attr is not False),
        lambda: (_param((np.random.RandomState(0)
                         .randn(filter_size * d, num_filters)
                         / np.sqrt(filter_size * d)).astype(np.float32),
                        input),
                 None if bias_attr is False else _param(
                     np.zeros((num_filters,), np.float32), input)),
        name=name)
    out = call_op("sequence_conv", input,
                  lengths if lengths is not None else _full_lengths(input),
                  w, bias=b, context_length=filter_size)
    return _act(out, act)


def sequence_pad(x, pad_value=0.0, maxlen=None, lengths=None, name=None):
    from ...nn import functional as F
    return F.sequence_pad(x, lengths if lengths is not None
                          else _full_lengths(x), maxlen=maxlen,
                          pad_value=pad_value)


def sequence_unpad(x, length, name=None):
    from ...nn import functional as F
    return F.sequence_unpad(x, length)


def sequence_expand(x, y, ref_level=-1, lengths=None, name=None):
    """Dense form: repeat x's rows per y's (or explicit) lengths; the
    static maxlen comes from y's time axis."""
    from ...nn import functional as F
    maxlen = int(y.shape[1]) if len(y.shape) >= 2 else 1
    return F.sequence_expand(x, lengths if lengths is not None
                             else _full_lengths(y), maxlen=maxlen)


def sequence_expand_as(x, y, name=None):
    return sequence_expand(x, y)


def sequence_concat(input, lengths_list=None, name=None):
    from ...nn import functional as F
    if lengths_list is None:
        lengths_list = [_full_lengths(x) for x in input]
    return F.sequence_concat(list(input), list(lengths_list))


def sequence_enumerate(input, win_size, lengths=None, pad_value=0,
                       name=None):
    from ...nn import functional as F
    return F.sequence_enumerate(
        input, lengths if lengths is not None else _full_lengths(input),
        win_size=win_size, pad_value=pad_value)


def sequence_slice(input, offset, length, lengths=None, name=None):
    from ...nn import functional as F
    return F.sequence_slice(
        input, lengths if lengths is not None else _full_lengths(input),
        offset, length)


def sequence_reshape(input, new_dim):
    """Reference sequence_reshape: re-chunk the feature dim (dense form:
    ``[B, T, D] -> [B, T*D//new_dim, new_dim]``)."""
    from ...framework.dispatch import call_op
    t, d = (int(s) for s in input.shape[1:])
    if (t * d) % new_dim:
        raise ValueError(f"cannot reshape T*D={t*d} into rows of "
                         f"{new_dim}")
    # batch stays symbolic (-1): static programs replay at any batch
    return call_op("reshape", input, shape=[-1, (t * d) // new_dim,
                                            new_dim])


def sequence_scatter(input, index, updates, name=None):
    """Reference sequence_scatter: add ``updates`` at per-row positions
    ``index`` (dense form over ``[B, T, ...]``); a registered op, so it
    records."""
    from ...framework.dispatch import call_op
    idx = index if isinstance(index, torch.Tensor) else torch.as_tensor(
        np.asarray(index), device=input.device)
    upd = updates if isinstance(updates, torch.Tensor) else torch.as_tensor(
        np.asarray(updates), device=input.device)
    return call_op("sequence_scatter", input, idx, upd)


class StaticRNN:
    """Fluid StaticRNN builder (reference fluid/layers/control_flow.py
    StaticRNN). The dense equivalent unrolls the step function over axis
    1 at build time, what fluid's sub-block execution did T times:

        rnn = StaticRNN()
        rnn.step_input(x)                       # [B, T, D]
        rnn.memory(init=h0)
        out = rnn.unroll(lambda x_t, h: (h_new, h_new))

    The fluid ``with rnn.step():`` recording protocol would need a
    sub-block IR; it raises with this guidance (``nn.RNN``/``nn.LSTM``
    serve the layer-level use)."""

    def __init__(self, name=None):
        self._inputs = []
        self._memories = []
        self._seq_len = None

    def step(self):
        raise NotImplementedError(
            "the fluid step-recording protocol is replaced by "
            "StaticRNN.unroll(step_fn) here (or nn.RNN/nn.LSTM for "
            "layer-level recurrence)")

    def step_input(self, x):
        self._inputs.append(x)
        self._seq_len = int(x.shape[1])
        return x

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, init_batch_dim_idx=0, ref_batch_dim_idx=0):
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory() needs init= or "
                                 "(shape=, batch_ref=)")
            b = int(batch_ref.shape[ref_batch_dim_idx])
            init = torch.full((b,) + tuple(shape), init_value,
                              dtype=torch.float32, device=batch_ref.device)
        self._memories.append(init)
        return init

    def unroll(self, step_fn):
        """Run ``step_fn(*x_ts, *states) -> (out, *new_states)`` over axis
        1 of EVERY step_input (in declaration order), unrolled; returns
        the stacked outputs ``[B, T, ...]``."""
        from ...framework.dispatch import call_op
        if not self._inputs:
            raise RuntimeError("call step_input(x) before unroll()")

        def _slice_t(x, t):
            xt = call_op("slice", x, axes=[1], starts=[t], ends=[t + 1])
            return call_op("reshape", xt,
                           shape=[-1] + list(x.shape[2:]))

        states = list(self._memories)
        outs = []
        for t in range(self._seq_len):
            xts = [_slice_t(x, t) for x in self._inputs]
            res = step_fn(*xts, *states)
            if not isinstance(res, (tuple, list)):
                res = (res,)
            out, states = res[0], list(res[1:]) or states
            outs.append(out)
        return call_op("stack", outs, axis=1)
