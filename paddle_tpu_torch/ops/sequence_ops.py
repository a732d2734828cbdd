"""Variable-length sequence ops (counterpart of
``paddle_tpu/ops/sequence_ops.py``), each op's plain body.

The encoding is the JAX package's: a dense padded tensor ``x [batch,
maxlen, ...]`` beside a ``lengths [batch]`` vector, in place of the
reference's LoD offsets. Every op masks by the lengths, so nothing here
reads a length back to the host: the masks, offsets and gather indices
are built on the lengths' device, and the output shapes come from the
static arguments (``maxlen``, ``total_length``, ``win_size``) as in the
JAX package. ``sequence_pad``/``sequence_unpad`` convert between the
packed ``[total, ...]`` layout and the dense one.

None of them is a Pallas kernel in the JAX package (they are lax), so
each runs as a composition of PyTorch ops on whichever device holds its
operands.
"""
from __future__ import annotations

import torch
from torch.nn import functional as TF

from .registry import register_op

_NEG_INF = -1e30


def _arange(n, like):
    return torch.arange(n, device=like.device)


def _mask2d(lengths, maxlen):
    """``[batch, maxlen]`` validity mask from a lengths vector."""
    return _arange(maxlen, lengths)[None, :] < lengths.reshape(-1, 1)


def _expand_mask(mask, x):
    """A ``[batch, maxlen]`` mask broadcast over ``x``'s feature dims."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - 2))


def _offsets(lengths):
    """Exclusive cumsum: each sequence's start in the packed layout."""
    return torch.cumsum(lengths, 0) - lengths


def _take_time(x, src):
    """``out[b, t] = x[b, src[b, t]]`` over ``x``'s feature dims (the JAX
    ``take_along_axis(x, src[..., None...], axis=1)``)."""
    b, t = src.shape
    idx = src.long().reshape((b, t) + (1,) * (x.dim() - 2)).expand(
        (b, t) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _full(value, x):
    return torch.full((), value, dtype=x.dtype, device=x.device)


# -- pack <-> pad ---------------------------------------------------------------

@register_op("sequence_pad")
def _sequence_pad(flat, lengths, pad_value=0.0, maxlen=None):
    """Packed ``[total, ...]`` + lengths to dense ``[batch, maxlen,
    ...]``; positions past each length hold ``pad_value``."""
    if maxlen is None:
        raise ValueError("sequence_pad: maxlen must be a static int "
                         "(dynamic output shapes cannot compile)")
    m = int(maxlen)
    idx = _offsets(lengths)[:, None] + _arange(m, lengths)[None, :]
    idx = idx.clamp(0, flat.shape[0] - 1)
    out = flat.index_select(0, idx.reshape(-1)).reshape(
        (lengths.shape[0], m) + tuple(flat.shape[1:]))
    mask = _expand_mask(_mask2d(lengths, m), out)
    return torch.where(mask, out, _full(pad_value, out))


@register_op("sequence_unpad")
def _sequence_unpad(x, lengths, total_length=None):
    """Dense ``[batch, maxlen, ...]`` to packed ``[total_length, ...]``;
    rows past ``sum(lengths)`` are zero."""
    batch, maxlen = x.shape[0], x.shape[1]
    total = int(total_length) if total_length is not None \
        else batch * maxlen
    ends = torch.cumsum(lengths, 0)
    i = _arange(total, lengths).to(ends.dtype)
    b = torch.searchsorted(ends, i, right=True).clamp(0, batch - 1)
    t = (i - _offsets(lengths)[b]).clamp(0, maxlen - 1)
    out = x[b, t]
    valid = (i < ends[-1]).reshape((total,) + (1,) * (x.dim() - 2))
    return torch.where(valid, out, _zero(x))


# -- masked reductions / normalization -------------------------------------------------

def _extreme(x, largest):
    """The identity of max (``largest``) or min in ``x``'s dtype."""
    if x.is_floating_point():
        return _NEG_INF if largest else -_NEG_INF
    if x.dtype == torch.bool:
        return not largest
    info = torch.iinfo(x.dtype)
    return info.min if largest else info.max


@register_op("sequence_pool")
def _sequence_pool(x, lengths, pool_type="sum"):
    """Per-sequence reduction over the time axis: ``sum``, ``average``
    (``mean``), ``sqrt``, ``max``, ``min``, ``first``, ``last``."""
    pt = pool_type.lower()
    mask = _expand_mask(_mask2d(lengths, x.shape[1]), x)
    ln = lengths.clamp(min=1).to(
        x.dtype if x.is_floating_point() else torch.float32)
    ln = ln.reshape((-1,) + (1,) * (x.dim() - 2))
    if pt in ("sum", "average", "mean", "sqrt"):
        total = torch.where(mask, x, _zero(x)).sum(dim=1)
        if pt == "sum":
            return total
        return total / (ln if pt != "sqrt" else torch.sqrt(ln))
    if pt in ("max", "min"):
        filled = torch.where(mask, x, _full(_extreme(x, pt == "max"), x))
        return filled.amax(dim=1) if pt == "max" else filled.amin(dim=1)
    if pt == "first":
        return x[:, 0]
    if pt == "last":
        idx = (lengths - 1).clamp(min=0).reshape(-1, 1)
        return _take_time(x, idx).squeeze(1)
    raise ValueError(f"sequence_pool: unknown pool_type {pool_type!r}")


@register_op("sequence_softmax")
def _sequence_softmax(x, lengths):
    """Masked softmax over the time axis; padded positions get 0."""
    mask = _expand_mask(_mask2d(lengths, x.shape[1]), x)
    logits = torch.where(mask, x, _full(_NEG_INF, x))
    m = logits.amax(dim=1, keepdim=True).detach()
    e = torch.where(mask, torch.exp(logits - m), _zero(x))
    return e / e.sum(dim=1, keepdim=True).clamp(min=1e-30)


# -- reordering / expansion ---------------------------------------------------------

@register_op("sequence_reverse")
def _sequence_reverse(x, lengths):
    """Reverse each valid prefix; padding stays in place."""
    t = _arange(x.shape[1], lengths)[None, :]
    ln = lengths.reshape(-1, 1)
    return _take_time(x, torch.where(t < ln, ln - 1 - t, t))


@register_op("sequence_expand")
def _sequence_expand(x, ref_lengths, maxlen=None):
    """``[batch, d...]`` to ``[batch, maxlen, d...]``: each row repeated
    for ``t < ref_lengths[b]``, zero after."""
    if maxlen is None:
        raise ValueError("sequence_expand: maxlen must be a static int")
    m = int(maxlen)
    out = x[:, None].expand((x.shape[0], m) + tuple(x.shape[1:]))
    mask = _expand_mask(_mask2d(ref_lengths, m), out)
    return torch.where(mask, out, _zero(x))


@register_op("sequence_slice")
def _sequence_slice(x, lengths, offset, length, maxlen=None):
    """``out[b, t] = x[b, offset[b] + t]`` for ``t < length[b]``, cut at
    each sequence's valid end (the JAX op's truncation); the time axis
    is ``maxlen`` (default: the input's)."""
    m = int(maxlen) if maxlen is not None else x.shape[1]
    off = torch.as_tensor(offset, device=x.device).reshape(-1, 1)
    ln = torch.as_tensor(length, device=x.device).reshape(-1, 1)
    seq_ln = torch.as_tensor(lengths, device=x.device).reshape(-1, 1)
    eff = torch.minimum(ln, seq_ln - off).clamp(min=0)
    t = _arange(m, x)[None, :]
    out = _take_time(x, (off + t).clamp(0, x.shape[1] - 1))
    return torch.where(_expand_mask(t < eff, out), out, _zero(x))


@register_op("sequence_enumerate")
def _sequence_enumerate(ids, lengths, win_size, pad_value=0):
    """Sliding windows of token ids: ``[batch, maxlen]`` to ``[batch,
    maxlen, win_size]``; cells past the sequence end hold
    ``pad_value``."""
    maxlen, w = ids.shape[1], int(win_size)
    t = _arange(maxlen, ids)[:, None] + _arange(w, ids)[None, :]
    out = ids[:, t.clamp(0, maxlen - 1)]
    valid = t[None] < lengths.reshape(-1, 1, 1)
    return torch.where(valid, out, _full(pad_value, ids))


# -- context-window convolution ------------------------------------------------------

@register_op("sequence_conv")
def _sequence_conv(x, lengths, weight, bias=None, context_length=3,
                   context_start=None, pad_value=0.0):
    """Context-window convolution over each sequence: ``context_length``
    shifted copies of the padding-zeroed input stacked on the feature
    axis, one product with ``weight [context_length * d_in, d_out]``;
    steps outside a sequence contribute ``pad_value``, padded outputs
    are zero."""
    cl = int(context_length)
    cs = int(context_start) if context_start is not None else -(cl // 2)
    steps = x.shape[1]
    mask = _expand_mask(_mask2d(lengths, steps), x)
    xz = torch.where(mask, x, _full(pad_value, x))
    t = _arange(steps, x)
    cols = []
    for k in range(cl):
        shift = cs + k
        rolled = torch.roll(xz, -shift, dims=1)
        inside = ((t + shift >= 0) & (t + shift < steps)).reshape(
            (1, -1) + (1,) * (x.dim() - 2))
        cols.append(torch.where(inside, rolled, _full(pad_value, x)))
    stacked = torch.cat(cols, dim=-1)
    out = torch.einsum("btd,do->bto", stacked.float(),
                       weight.float()).to(x.dtype)
    if bias is not None:
        out = out + bias
    omask = _expand_mask(_mask2d(lengths, steps), out)
    return torch.where(omask, out, _zero(out))


@register_op("sequence_concat")
def _sequence_concat(xs, lengths_list, maxlen=None):
    """Sequence ``b`` of the output is the concatenation of every input's
    valid prefix ``b``. Returns ``(padded, total_lengths)``; ``maxlen``
    defaults to the sum of the inputs' maxlens."""
    m = int(maxlen) if maxlen is not None else sum(x.shape[1] for x in xs)
    total_len = lengths_list[0]
    for ln in lengths_list[1:]:
        total_len = total_len + ln
    out = torch.zeros((xs[0].shape[0], m) + tuple(xs[0].shape[2:]),
                      dtype=xs[0].dtype, device=xs[0].device)
    t = _arange(m, xs[0])[None, :]
    running = torch.zeros((xs[0].shape[0], 1), dtype=lengths_list[0].dtype,
                          device=lengths_list[0].device)
    for x, ln in zip(xs, lengths_list):
        lnc = ln.reshape(-1, 1)
        gathered = _take_time(x, (t - running).clamp(0, x.shape[1] - 1))
        sel = (t >= running) & (t < running + lnc)
        out = torch.where(_expand_mask(sel, out), gathered, out)
        running = running + lnc
    return out, total_len


@register_op("row_conv")
def _row_conv(x, weight):
    """Lookahead row convolution: ``out[t] = sum_i weight[i] * x[t + i]``
    with a zero-padded tail."""
    k, steps = weight.shape[0], x.shape[-2]
    xp = TF.pad(x, (0, 0, 0, k - 1))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[..., i:i + steps, :] * weight[i]
    return out


@register_op("sequence_scatter")
def _sequence_scatter(x, index, updates):
    """Add ``updates [B, K, ...]`` at each row's time positions ``index
    [B, K]``."""
    rows = _arange(x.shape[0], x)[:, None].expand(index.shape)
    return x.index_put((rows, index.long()), updates.to(x.dtype),
                       accumulate=True)


@register_op("nce_loss")
def _nce_loss(x, label, weight, bias, neg_samples):
    """Noise-contrastive estimation: the logistic loss of the true class
    and of the given negative sample ids, ``[batch, 1]``."""
    lab = label.reshape(-1).long()
    pos_logit = (x * weight[lab]).sum(-1) + bias[lab]
    neg = neg_samples.long()
    neg_logit = torch.einsum("bd,bkd->bk", x, weight[neg]) + bias[neg]
    loss = TF.softplus(-pos_logit) + TF.softplus(neg_logit).sum(-1)
    return loss.reshape(-1, 1)
