"""The extended nn ops (counterpart of ``paddle_tpu/ops/extra_nn_ops.py``):
the 1-D and 3-D transposed convolutions, the 3-D adaptive pools, fold,
max pooling with its argmax mask and max unpooling, pixel unshuffle,
channel shuffle, the temporal shift, grid sampling and affine grids,
``gather_tree``, the CTC loss, the hierarchical sigmoid, the margin
cross-entropy with its class-centre sampler, and CSR sparse attention,
each op's plain body.

None of them is a Pallas kernel in the JAX package (they are lax), so
each runs as a composition of PyTorch ops on whichever device holds its
operands. Where the JAX op runs a ``lax.scan`` (``gather_tree``,
``ctc_loss``) the body loops over the scanned axis in Python; where it
samples on the host with numpy (``class_center_sample``) the body samples
on the label's device from a ``torch.Generator``, so the draws differ
from the JAX op's and only the rule is the same. Indices come back in the
JAX op's dtype: the pooling mask as int32, flat over the unpadded spatial
dims, the layout ``max_unpool*`` reads back.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as TF

from ..framework.random import get_generator
from .nn_ops import (_adaptive_pool, _conv_padding, _conv_transpose_nd,
                     _flat_pads, _ntuple)
from .registry import register_op

_NEG_INF = -1e30


# -- transposed convolutions ------------------------------------------------------

@register_op("conv1d_transpose")
def _conv1d_transpose(x, w, bias=None, stride=1, padding=0, output_padding=0,
                      dilation=1, groups=1, data_format="NCL",
                      output_size=None):
    return _conv_transpose_nd(x, w, bias, stride, padding, output_padding,
                              dilation, groups,
                              data_format not in ("NCL", "NCW"), 1)


@register_op("conv3d_transpose")
def _conv3d_transpose(x, w, bias=None, stride=1, padding=0, output_padding=0,
                      dilation=1, groups=1, data_format="NCDHW",
                      output_size=None):
    return _conv_transpose_nd(x, w, bias, stride, padding, output_padding,
                              dilation, groups,
                              not data_format.startswith("NC"), 3)


# -- adaptive 3-D pooling --------------------------------------------------------------

@register_op("adaptive_avg_pool3d")
def _adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return _adaptive_pool(x, output_size, 3, data_format, "avg")


@register_op("adaptive_max_pool3d")
def _adaptive_max_pool3d(x, output_size, data_format="NCDHW"):
    return _adaptive_pool(x, output_size, 3, data_format, "max")


# -- fold, pooling with a mask, unpooling ------------------------------------------------

@register_op("fold")
def _fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    """col2im, the adjoint of ``unfold``: ``x [N, C * kh * kw, L]`` to
    ``[N, C, H, W]``, overlaps summed. The pads may differ a side: the
    columns fold into the padded image, which is then cut."""
    hs, ws = _ntuple(output_sizes, 2)
    (pt, pb), (pl, pr) = _conv_padding(paddings, 2)
    out = TF.fold(x, (hs + pt + pb, ws + pl + pr), _ntuple(kernel_sizes, 2),
                  dilation=_ntuple(dilations, 2), padding=0,
                  stride=_ntuple(strides, 2))
    return out[:, :, pt:pt + hs, pl:pl + ws]


_MAX_WITH_INDICES = {1: TF.max_pool1d_with_indices,
                     2: TF.max_pool2d_with_indices,
                     3: TF.max_pool3d_with_indices}


def _max_pool_with_mask(x, kernel_size, stride, padding, nd,
                        ceil_mode=False):
    """``(pooled, mask)``: the max of each window and the flat index, over
    the unpadded spatial dims, of the element that holds it (the first
    in window order on a tie), as int32. The pads hold the dtype's finite
    minimum (the JAX op's fill) and ``ceil_mode`` extends each dim's high
    pad so that a trailing partial window gives one more output."""
    ks = _ntuple(kernel_size, nd)
    st = _ntuple(stride if stride is not None else kernel_size, nd)
    pads = _conv_padding(padding, nd)
    spatial = tuple(x.shape[2:])
    if ceil_mode:
        pads = [(p0, p1 + (-(L + p0 + p1 - k)) % s)
                for (p0, p1), L, k, s in zip(pads, spatial, ks, st)]
    low = torch.finfo(x.dtype).min if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    xp = TF.pad(x, _flat_pads(pads), value=low)
    pooled, arg = _MAX_WITH_INDICES[nd](xp, ks, st)
    # a flat index into the padded dims -> one into the unpadded ones
    mask = torch.zeros_like(arg)
    rest = arg
    for d in reversed(range(nd)):
        padded = xp.shape[2 + d]
        coord = rest % padded - pads[d][0]
        rest = rest // padded
        mask = mask + coord * math.prod(spatial[d + 1:])
    return pooled, mask.to(torch.int32)


@register_op("max_pool1d_with_mask")
def _max_pool1d_mask(x, kernel_size, stride=None, padding=0,
                     ceil_mode=False):
    return _max_pool_with_mask(x, kernel_size, stride, padding, 1, ceil_mode)


@register_op("max_pool2d_with_mask")
def _max_pool2d_mask(x, kernel_size, stride=None, padding=0,
                     ceil_mode=False):
    return _max_pool_with_mask(x, kernel_size, stride, padding, 2, ceil_mode)


@register_op("max_pool3d_with_mask")
def _max_pool3d_mask(x, kernel_size, stride=None, padding=0,
                     ceil_mode=False):
    return _max_pool_with_mask(x, kernel_size, stride, padding, 3, ceil_mode)


def _max_unpool(x, indices, kernel_size, stride, padding, output_size, nd):
    """Each value of ``x`` written at its flat spatial index into zeros of
    the output size (``output_size``'s last ``nd`` values, else
    ``(in - 1) * stride - 2 * pad + kernel``)."""
    ks = _ntuple(kernel_size, nd)
    st = _ntuple(stride if stride is not None else kernel_size, nd)
    pd = _conv_padding(padding, nd)
    if output_size is not None:
        out_sp = tuple(int(v) for v in output_size)[-nd:]
    else:
        out_sp = tuple((x.shape[2 + d] - 1) * st[d] - 2 * pd[d][0] + ks[d]
                       for d in range(nd))
    n, c = x.shape[:2]
    flat = x.reshape(n * c, -1)
    out = flat.new_zeros(n * c, math.prod(out_sp)).scatter(
        1, indices.reshape(n * c, -1).long(), flat)
    return out.reshape((n, c) + out_sp)


@register_op("max_unpool1d")
def _max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                  output_size=None):
    return _max_unpool(x, indices, kernel_size, stride, padding,
                       output_size, 1)


@register_op("max_unpool2d")
def _max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                  output_size=None):
    return _max_unpool(x, indices, kernel_size, stride, padding,
                       output_size, 2)


@register_op("max_unpool3d")
def _max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                  output_size=None):
    return _max_unpool(x, indices, kernel_size, stride, padding,
                       output_size, 3)


# -- channel and pixel rearrangement, the temporal shift --------------------------------

@register_op("pixel_unshuffle")
def _pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    r = int(downscale_factor)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // r, w // r, c * r * r)


@register_op("channel_shuffle")
def _channel_shuffle(x, groups, data_format="NCHW"):
    g = int(groups)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(
            n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, g, c // g).transpose(3, 4).reshape(n, h, w, c)


@register_op("temporal_shift")
def _temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    """The TSM shift: of each clip's ``seg_num`` frames, the first
    ``shift_ratio`` of the channels move one frame later, the next as many
    one frame earlier (zeros enter), the rest stay."""
    if data_format != "NCHW":
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    t = int(seg_num)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    xs = x.reshape(nt // t, t, c, h, w)
    fwd = torch.cat([torch.zeros_like(xs[:, :1, :c1]), xs[:, :-1, :c1]],
                    dim=1)
    bwd = torch.cat([xs[:, 1:, c1:c2], torch.zeros_like(xs[:, :1, c1:c2])],
                    dim=1)
    out = torch.cat([fwd, bwd, xs[:, :, c2:]], dim=2).reshape(nt, c, h, w)
    return out.permute(0, 2, 3, 1) if data_format != "NCHW" else out


# -- grid sampling -----------------------------------------------------------------------

def _gs_unnormalize(coord, size, align_corners):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _gs_reflect(coord, size, align_corners):
    lo, hi = (0.0, float(size - 1)) if align_corners \
        else (-0.5, size - 0.5)
    span = hi - lo
    if span <= 0:
        return torch.zeros_like(coord)
    c = torch.remainder((coord - lo).abs(), 2 * span)
    return lo + torch.where(c > span, 2 * span - c, c)


@register_op("grid_sample")
def _grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                 align_corners=True):
    """``x [N, C, H, W]`` sampled at ``grid [N, Ho, Wo, 2]`` (x, y in
    [-1, 1]) as the JAX op computes it: the corners gathered by flat index
    with zeros outside, ``border`` and ``reflection`` clipping the
    coordinates first."""
    n, c, h, w = x.shape
    gx = _gs_unnormalize(grid[..., 0].float(), w, align_corners)
    gy = _gs_unnormalize(grid[..., 1].float(), h, align_corners)
    if padding_mode == "border":
        gx, gy = gx.clamp(0, w - 1), gy.clamp(0, h - 1)
    elif padding_mode == "reflection":
        gx = _gs_reflect(gx, w, align_corners).clamp(0, w - 1)
        gy = _gs_reflect(gy, h, align_corners).clamp(0, h - 1)
    flat = x.reshape(n, c, h * w)

    def sample(ix, iy):
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        lin = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(n, 1, -1)
        vals = flat.gather(2, lin.expand(n, c, lin.shape[-1])).reshape(
            (n, c) + tuple(ix.shape[1:]))
        return torch.where(valid[:, None], vals, 0.0)

    if mode == "nearest":
        return sample(torch.round(gx).long(), torch.round(gy).long()).to(
            x.dtype)
    x0, y0 = torch.floor(gx).long(), torch.floor(gy).long()
    wx, wy = (gx - x0)[:, None], (gy - y0)[:, None]
    out = (sample(x0, y0) * (1 - wx) * (1 - wy)
           + sample(x0 + 1, y0) * wx * (1 - wy)
           + sample(x0, y0 + 1) * (1 - wx) * wy
           + sample(x0 + 1, y0 + 1) * wx * wy)
    return out.to(x.dtype)


@register_op("affine_grid")
def _affine_grid(theta, out_shape, align_corners=True):
    """The sampling grid ``[N, H, W, 2]`` of the affine maps ``theta [N,
    2, 3]`` over ``out_shape`` ``(N, C, H, W)``."""
    _, _, h, w = (int(v) for v in out_shape)
    dev = theta.device

    def base(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, device=dev)
        return (torch.arange(size, device=dev) * 2 + 1) / size - 1.0

    gy, gx = torch.meshgrid(base(h), base(w), indexing="ij")
    coords = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(
        1, h * w, 3)
    out = torch.einsum("bij,bpj->bpi", theta.float(),
                       coords.expand(theta.shape[0], h * w, 3))
    return out.reshape(theta.shape[0], h, w, 2).to(theta.dtype)


# -- gather_tree ----------------------------------------------------------------------------

@register_op("gather_tree")
def _gather_tree(ids, parents):
    """``ids``/``parents`` ``[max_time, batch, beam]``: the full sequence
    of each final beam, walking the parent pointers from the last step
    back (the JAX op's reverse scan)."""
    t, b, k = ids.shape
    cur = torch.arange(k, device=ids.device).expand(b, k).to(ids.dtype)
    outs = []
    for step in reversed(range(t)):
        idx = cur.long()
        outs.append(ids[step].gather(1, idx))
        cur = parents[step].gather(1, idx)
    return torch.stack(outs[::-1])


# -- CTC loss ---------------------------------------------------------------------------------

def _logsumexp3(a, b, c):
    """``log(exp a + exp b + exp c)`` over ``_NEG_INF`` lanes as the JAX
    op writes it: a lane whose largest term is ``_NEG_INF`` stays there,
    and its log sees 1 (the double ``where`` keeps NaN out of the
    gradient)."""
    m = torch.maximum(torch.maximum(a, b), c)
    dead = m <= _NEG_INF
    msafe = torch.where(dead, 0.0, m)
    inner = (a - msafe).exp() + (b - msafe).exp() + (c - msafe).exp()
    return torch.where(dead, _NEG_INF,
                       msafe + torch.log(torch.where(dead, 1.0, inner)))


@register_op("ctc_loss")
def _ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0):
    """The negative log-likelihood ``[N]`` (float32) of each label
    sequence under ``log_probs [T, N, C]`` (log-softmaxed here): the
    forward algorithm in log space over the blank-interleaved labels,
    ``alpha`` frozen past each sample's input length."""
    lp = torch.log_softmax(log_probs.float(), dim=-1)
    t_max, n, _ = lp.shape
    s = 2 * labels.shape[1] + 1
    dev = lp.device
    ext = torch.full((n, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    lab_len = label_lengths.long().reshape(n)
    in_len = input_lengths.long().reshape(n)
    prev2 = torch.cat([torch.full((n, 2), -1, dtype=torch.long, device=dev),
                       ext[:, :-2]], dim=1)
    skip_ok = (ext != blank) & (ext != prev2)
    pos = torch.arange(s, device=dev)[None, :]
    neg = torch.full((n, 1), _NEG_INF, device=dev)
    first = lp[0].gather(1, ext)
    alpha = torch.full((n, s), _NEG_INF, device=dev)
    alpha = torch.where(pos == 0, first, alpha)
    alpha = torch.where((pos == 1) & (lab_len[:, None] > 0), first, alpha)
    for t in range(1, t_max):
        shift1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        shift2 = torch.where(skip_ok, torch.cat([neg, neg, alpha[:, :-2]],
                                                dim=1), _NEG_INF)
        new = _logsumexp3(alpha, shift1, shift2) + lp[t].gather(1, ext)
        alpha = torch.where(t < in_len[:, None], new, alpha)
    ext_len = 2 * lab_len + 1
    last1 = alpha.gather(1, (ext_len - 1)[:, None])[:, 0]
    last2 = torch.where(
        lab_len > 0,
        alpha.gather(1, (ext_len - 2).clamp_min(0)[:, None])[:, 0],
        _NEG_INF)
    m = torch.maximum(last1, last2)
    dead = m <= _NEG_INF
    msafe = torch.where(dead, 0.0, m)
    inner = (last1 - msafe).exp() + (last2 - msafe).exp()
    return -(msafe + torch.log(torch.where(dead, 1.0, inner)))


# -- hierarchical sigmoid -------------------------------------------------------------------

@register_op("hsigmoid_loss")
def _hsigmoid_loss(x, label, weight, bias=None, path_table=None,
                   path_code=None, num_classes=2):
    """The loss ``[N, 1]`` of each sample's path through a binary tree of
    internal nodes (``weight [nodes, F]``): by default the reference's
    SimpleCode tree (``code = label + num_classes``; the node at depth
    ``j`` is ``(code >> (len - j)) - 1`` and the branch bit ``(code >>
    (len - 1 - j)) & 1``, ``len = floor(log2(code))``), or the custom
    ``path_table`` (node ids, -1 padded) and ``path_code`` (bits)."""
    xf = x.float()
    n = x.shape[0]
    if path_table is None:
        depth = int(math.ceil(math.log2(max(int(num_classes), 2))))
        code = label.long().reshape(n) + int(num_classes)
        lengths = torch.floor(torch.log2(code.float())).long()
        j = torch.arange(depth, device=x.device)[None, :]
        active = j < lengths[:, None]
        idx = torch.where(active, (code[:, None] >> (
            lengths[:, None] - j).clamp_min(0)) - 1, 0)
        bits = torch.where(active, (code[:, None] >> (
            lengths[:, None] - 1 - j).clamp_min(0)) & 1, 0)
    else:
        idx = path_table.long()
        active = idx >= 0
        idx = torch.where(active, idx, 0)
        bits = torch.where(active, path_code.long(), 0)
    logits = torch.einsum("nf,ndf->nd", xf, weight.float()[idx])
    if bias is not None:
        logits = logits + bias.float().reshape(-1)[idx]
    # the logistic loss of each node's branch: -log sigmoid(+-logit)
    per_node = torch.logaddexp(logits, torch.zeros_like(logits)) \
        - bits * logits
    loss = torch.where(active, per_node, 0.0).sum(dim=1, keepdim=True)
    return loss.to(x.dtype)


# -- margin cross-entropy and class-centre sampling ------------------------------------------

@register_op("margin_cross_entropy")
def _margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                          margin3=0.0, scale=64.0, return_softmax=False):
    """The combined-margin (ArcFace) softmax loss ``[N, 1]`` over cosine
    ``logits [N, C]``: the target logit becomes ``cos(margin1 * theta +
    margin2) - margin3``, then every logit is scaled by ``scale``."""
    lf = logits.float()
    c = lf.shape[1]
    onehot = TF.one_hot(label.long().reshape(-1), c).float()
    target = (lf * onehot).sum(dim=1)
    theta = torch.arccos(target.clamp(-1.0, 1.0))
    target_m = torch.cos(margin1 * theta + margin2) - margin3
    mod = (lf * (1 - onehot) + target_m[:, None] * onehot) * scale
    logp = torch.log_softmax(mod, dim=1)
    loss = (-(logp * onehot).sum(dim=1, keepdim=True)).to(logits.dtype)
    if return_softmax:
        return loss, logp.exp().to(logits.dtype)
    return loss


@register_op("class_center_sample")
def _class_center_sample(label, num_classes, num_samples, seed=None,
                         generator=None):
    """``(remapped labels, sampled class ids)``, both int64 on the label's
    device: every class of ``label`` is kept, and when they are fewer
    than ``num_samples`` the rest are drawn uniformly without replacement
    from the other classes (from ``generator``, else one seeded with
    ``seed``, else the port's generator of the device); the ids come
    sorted, and each label is replaced by its id's position among them.
    The positives' count sets the output size, so it is read back."""
    lab = label.reshape(-1).long()
    dev = lab.device
    n_total, n_samp = int(num_classes), int(num_samples)
    positive = torch.zeros(n_total, dtype=torch.bool, device=dev)
    positive[lab] = True
    n_pos = int(positive.sum())
    if n_pos < n_samp:
        if generator is None:
            generator = get_generator(dev) if seed is None else \
                torch.Generator(device=dev).manual_seed(int(seed))
        order = torch.randperm(n_total, generator=generator, device=dev)
        negatives = order[~positive[order]][:n_samp - n_pos]
        positive[negatives] = True
    sampled = torch.nonzero(positive)[:, 0]
    remap = torch.full((n_total,), -1, dtype=torch.long, device=dev)
    remap[sampled] = torch.arange(sampled.numel(), device=dev)
    return remap[lab], sampled


# -- CSR sparse attention --------------------------------------------------------------------

@register_op("sparse_attention")
def _sparse_attention(q, k, v, offset, columns, key_padding_mask=None,
                      attn_mask=None):
    """Softmax attention ``[B, H, L, D]`` restricted to the CSR pattern
    ``offset [B, H, L + 1]``/``columns [B, H, nnz]``: the pattern as a
    dense mask, then the masked softmax in float32 (a row with no entry
    gives zeros); ``key_padding_mask [B, L]`` and ``attn_mask [L, L]``
    are additive."""
    b, h, l, d = q.shape
    nnz = columns.shape[-1]
    dev = q.device
    slot = torch.arange(nnz, device=dev)
    # row r owns slots [offset[r], offset[r + 1])
    row = (slot[None, None, :, None] >= offset[..., None, 1:]).sum(-1)
    valid = slot[None, None, :] < offset[..., -1:]
    hits = torch.zeros(b, h, l, l, dtype=torch.int32, device=dev)
    hits.index_put_((torch.arange(b, device=dev)[:, None, None],
                     torch.arange(h, device=dev)[None, :, None],
                     row.clamp_max(l - 1), columns.long()),
                    valid.to(torch.int32), accumulate=True)
    mask = hits > 0
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(float(d))
    if key_padding_mask is not None:
        logits = logits + key_padding_mask.float()[:, None, None, :]
    if attn_mask is not None:
        logits = logits + attn_mask.float()[None, None]
    probs = torch.softmax(logits.masked_fill(~mask, _NEG_INF), dim=-1)
    probs = torch.where(mask, probs, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
