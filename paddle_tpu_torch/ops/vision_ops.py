"""The detection ops of ``vision.ops`` (counterpart of the op bodies in
``paddle_tpu/vision/ops.py``): ``roi_align``, ``roi_pool``,
``psroi_pool``, ``nms``, ``deform_conv2d``, ``yolo_box`` and
``yolo_loss``, registered as ops of the library.

They run with torch ops on their inputs' device; none is a Pallas kernel
in the JAX package. Where the JAX op gathers a whole feature map for each
region (a ``vmap`` that XLA fuses), the port keeps memory bounded:

* ``roi_align`` is separable. Each region's bilinear samples, averaged
  over a bin, are a ``[bins, H]`` matrix on the left and a ``[W, bins]``
  one on the right of the image's ``[C, H, W]`` map, so it is two
  products a region;
* ``roi_pool`` takes its maxima in two passes (over each bin's rows, then
  its columns) and ``psroi_pool`` its sums the same way, in chunks of
  regions;
* ``nms`` runs on the device: the IoU matrix in score order, then the
  greedy keep/suppress recursion solved by iterating ``keep[j] = no kept
  earlier box overlaps j`` to its fixed point, which is unique, since
  each box depends only on the boxes before it.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register_op

#: the elements a chunk of regions may hold in ``roi_pool``/``psroi_pool``
_CHUNK_ELEMS = 1 << 26


def _div(t, n):
    """``t / n`` divided as the CPU divides it: CUDA's division of a tensor
    by a Python number multiplies by the number's float32 reciprocal,
    which can round differently, and a bin's bounds are floors and
    ceilings of such quotients."""
    return t / torch.full((), float(n), dtype=t.dtype, device=t.device)


def _pair(v):
    return (int(v), int(v)) if isinstance(v, (int, np.integer)) \
        else tuple(int(a) for a in v)


def _image_of_roi(boxes_num, n_boxes, device):
    counts = np.asarray(boxes_num, np.int64).reshape(-1)
    if int(counts.sum()) != n_boxes:
        raise ValueError(f"boxes_num must sum to len(boxes): "
                         f"{int(counts.sum())} != {n_boxes}")
    return torch.from_numpy(np.repeat(np.arange(len(counts)), counts)).to(
        device), counts


def _interp_rows(coords, size):
    """``[R, O, S]`` sample coordinates along one axis of length ``size``
    -> ``[R, O, size]``: each row the mean over the ``S`` samples of the
    bilinear weights, border-clamped, zero for a sample outside ``[-1,
    size]`` (the JAX ``_roi_bilinear``)."""
    r, o, s = coords.shape
    c0 = torch.floor(coords)
    frac = coords - c0
    lo = c0.clamp(0, size - 1).to(torch.int64)
    hi = (c0 + 1).clamp(0, size - 1).to(torch.int64)
    valid = ((coords >= -1) & (coords <= size)).to(coords.dtype)
    out = coords.new_zeros((r, o, s, size))
    out.scatter_add_(3, lo[..., None], ((1 - frac) * valid)[..., None])
    out.scatter_add_(3, hi[..., None], (frac * valid)[..., None])
    return out.mean(2)


@register_op("roi_align")
def _roi_align(x, boxes, boxes_num, output_size=1, spatial_scale=1.0,
               sampling_ratio=-1, aligned=True):
    """RoI Align over ``x [N, C, H, W]`` and ``boxes [R, 4]`` (xyxy,
    ``boxes_num`` boxes an image): ``sampling_ratio <= 0`` samples each
    bin on ``ceil(H / oh)`` x ``ceil(W / ow)`` points, at most 8 a side,
    as the JAX op does. Returns ``[R, C, oh, ow]`` in ``x``'s dtype."""
    oh, ow = _pair(output_size)
    img, _ = _image_of_roi(boxes_num, boxes.shape[0], x.device)
    n, c, h, w = x.shape
    if sampling_ratio > 0:
        sry = srx = int(sampling_ratio)
    else:
        sry = min(8, max(1, -(-h // oh)))
        srx = min(8, max(1, -(-w // ow)))
    off = 0.5 if aligned else 0.0
    b = boxes.float() * spatial_scale
    x1, y1 = b[:, 0] - off, b[:, 1] - off
    rw, rh = b[:, 2] - off - x1, b[:, 3] - off - y1
    if not aligned:
        rw, rh = rw.clamp(min=1.0), rh.clamp(min=1.0)
    bin_h, bin_w = _div(rh, oh), _div(rw, ow)
    dev = x.device
    iy = (torch.arange(oh, device=dev)[None, :, None] * bin_h[:, None, None]
          + y1[:, None, None] + (torch.arange(sry, device=dev)[None, None, :]
                                 + 0.5) * _div(bin_h, sry)[:, None, None])
    ix = (torch.arange(ow, device=dev)[None, :, None] * bin_w[:, None, None]
          + x1[:, None, None] + (torch.arange(srx, device=dev)[None, None, :]
                                 + 0.5) * _div(bin_w, srx)[:, None, None])
    ay = _interp_rows(iy, h)                           # [R, oh, H]
    ax = _interp_rows(ix, w)                           # [R, ow, W]
    xf = x.float()
    out = x.new_zeros((boxes.shape[0], c, oh, ow), dtype=torch.float32)
    # a chunk's [r, C, oh, W] intermediate stays within the budget
    step = max(1, _CHUNK_ELEMS // max(1, c * oh * w))
    for lo in range(0, boxes.shape[0], step):
        sl = slice(lo, lo + step)
        t = torch.matmul(ay[sl, None], xf[img[sl]])    # [r, C, oh, W]
        out[sl] = torch.matmul(t, ax[sl, None].transpose(-1, -2))
    return out.to(x.dtype)


def _bin_masks(start, end, size):
    """``[R, O]`` bin bounds -> ``[R, O, size]`` bool: ``start <= i <
    end``, both clipped to ``[0, size]``."""
    i = torch.arange(size, device=start.device, dtype=torch.float32)
    return (i >= start.clamp(0, size)[..., None]) & \
        (i < end.clamp(0, size)[..., None])


def _bins(b1, extent, n_out, size):
    """The JAX ops' integer bins along one axis: ``floor(k * bin + b1)``
    to ``ceil((k + 1) * bin + b1)`` for ``k < n_out``, as masks."""
    k = torch.arange(n_out, device=b1.device, dtype=torch.float32)
    bin_ = _div(extent, n_out)[:, None]
    return _bin_masks(torch.floor(k * bin_ + b1[:, None]),
                      torch.ceil((k + 1) * bin_ + b1[:, None]), size)


@register_op("roi_pool")
def _roi_pool(x, boxes, boxes_num, output_size=1, spatial_scale=1.0):
    """RoI max pooling: each bin the maximum of its cells of the rounded
    box, 0 for an empty bin. ``[R, C, oh, ow]`` in ``x``'s dtype."""
    oh, ow = _pair(output_size)
    img, _ = _image_of_roi(boxes_num, boxes.shape[0], x.device)
    n, c, h, w = x.shape
    b = torch.round(boxes.float() * spatial_scale)
    x1, y1, x2, y2 = b.unbind(1)
    ym = _bins(y1, (y2 - y1 + 1).clamp(min=1.0), oh, h)     # [R, oh, H]
    xm = _bins(x1, (x2 - x1 + 1).clamp(min=1.0), ow, w)     # [R, ow, W]
    xf = x.float()
    r_all = boxes.shape[0]
    out = x.new_zeros((r_all, c, oh, ow), dtype=torch.float32)
    step = max(1, _CHUNK_ELEMS // max(1, c * oh * h * w))
    neg = torch.tensor(float("-inf"), device=x.device)
    for lo in range(0, r_all, step):
        sl = slice(lo, lo + step)
        feats = xf[img[sl]]                                   # [r, C, H, W]
        rows = torch.where(ym[sl][:, None, :, :, None], feats[:, :, None],
                           neg).amax(3)                       # [r, C, oh, W]
        out[sl] = torch.where(xm[sl][:, None, None], rows[:, :, :, None],
                              neg).amax(-1)                   # [r, C, oh, ow]
    empty = ~(ym.any(-1)[:, :, None] & xm.any(-1)[:, None, :])
    return torch.where(empty[:, None], 0.0, out).to(x.dtype)


@register_op("psroi_pool")
def _psroi_pool(x, boxes, boxes_num, output_size=1, spatial_scale=1.0):
    """Position-sensitive RoI average pooling: ``x``'s ``C = out_c * oh *
    ow`` channels, bin ``(i, j)`` averaging channel slice ``i * ow + j``
    over its cells. ``[R, out_c, oh, ow]`` in ``x``'s dtype."""
    oh, ow = _pair(output_size)
    img, counts = _image_of_roi(boxes_num, boxes.shape[0], x.device)
    n, c, h, w = x.shape
    out_c = c // (oh * ow)
    b = boxes.float() * spatial_scale
    x1, y1, x2, y2 = b.unbind(1)
    ym = _bins(y1, (y2 - y1).clamp(min=0.1), oh, h).float()
    xm = _bins(x1, (x2 - x1).clamp(min=0.1), ow, w).float()
    fps = x.float().reshape(n, out_c, oh, ow, h, w)
    out = []
    start = 0
    step = max(1, _CHUNK_ELEMS // max(1, out_c * oh * ow * h))
    for im, cnt in enumerate(counts.tolist()):
        for lo in range(start, start + cnt, step):
            sl = slice(lo, min(lo + step, start + cnt))
            cols = torch.einsum("rjx,cijyx->rcijy", xm[sl], fps[im])
            out.append(torch.einsum("riy,rcijy->rcij", ym[sl], cols))
        start += cnt
    s = torch.cat(out) if out else x.new_zeros((0, out_c, oh, ow),
                                               dtype=torch.float32)
    cnt = (ym.sum(-1)[:, :, None] * xm.sum(-1)[:, None, :]).clamp(min=1)
    return (s / cnt[:, None]).to(x.dtype)


def _box_iou(b):
    """Pairwise IoU of ``[M, 4]`` xyxy boxes, the JAX ``nms``'s formula."""
    x1, y1, x2, y2 = b.unbind(1)
    areas = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    iw = (torch.minimum(x2[:, None], x2[None]) -
          torch.maximum(x1[:, None], x1[None])).clamp(min=0)
    ih = (torch.minimum(y2[:, None], y2[None]) -
          torch.maximum(y1[:, None], y1[None])).clamp(min=0)
    inter = iw * ih
    return inter / torch.clamp(areas[:, None] + areas[None] - inter,
                               min=1e-10)


def _greedy_keep(suppress):
    """The greedy NMS keep mask over boxes in score order, given
    ``suppress [M, M]`` (box ``i`` suppresses a later box ``j``): the
    fixed point of ``keep[j] = not any(keep[i] and suppress[i, j])``,
    reached from all-kept (one host read an iteration; as many
    iterations as the longest suppression chain, plus one)."""
    m = suppress.shape[0]
    keep = torch.ones(m, dtype=torch.bool, device=suppress.device)
    sup = suppress.float()
    for _ in range(m + 1):
        new = (keep.float() @ sup) == 0
        if torch.equal(new, keep):
            return keep
        keep = new
    return keep


@register_op("nms")
def _nms(boxes, scores=None, iou_threshold=0.3, top_k=None,
         category_idxs=None, categories=None):
    """Hard NMS on the boxes' device: the kept indices (int64) in score
    order (input order without ``scores``; equal scores keep input
    order). With ``category_idxs``, only boxes of one category suppress
    each other and only the ``categories`` listed are kept; the kept
    boxes are ordered by score, ties by the category's place in
    ``categories`` (the JAX ``nms``'s concatenation order)."""
    b = boxes.float()
    m = b.shape[0]
    dev = b.device
    idx = torch.arange(m, device=dev)
    if category_idxs is not None:
        cat = category_idxs.reshape(-1).to(dev)
        listed = torch.as_tensor(list(categories), device=dev,
                                 dtype=cat.dtype)
        rank = torch.argmax((cat[:, None] == listed[None]).to(torch.int32),
                            dim=1)
        chosen = (cat[:, None] == listed[None]).any(1)
        # the JAX order: by category's place, then score, then index
        s = scores.reshape(-1).float()
        order = idx[torch.argsort(-s, stable=True)]
        order = order[torch.argsort(rank[order], stable=True)]
        order = order[chosen[order]]
    elif scores is None:
        order = idx
    else:
        order = torch.argsort(-scores.reshape(-1).float(), stable=True)
    bs = b[order]
    sup = torch.triu(_box_iou(bs) > iou_threshold, diagonal=1)
    if category_idxs is not None:
        co = cat[order]
        sup &= co[:, None] == co[None]
    kept = order[_greedy_keep(sup)]
    if category_idxs is not None:
        kept = kept[torch.argsort(-s[kept], stable=True)]
    if top_k is not None:
        kept = kept[:int(top_k)]
    return kept.to(torch.int64)


def _bilinear_zero(sub, py, px):
    """``sub [N, C, H, W]`` sampled at ``[N, K, oh, ow]`` coordinates,
    bilinear with every corner outside the map reading 0 (deformable
    convolution's rule) -> ``[N, C, K, oh, ow]``."""
    n, c, fh, fw = sub.shape
    flat = sub.reshape(n, c, fh * fw)
    y0, x0 = torch.floor(py), torch.floor(px)
    ly, lx = py - y0, px - x0
    out = 0.0
    for yy, xx, wt in ((y0, x0, (1 - ly) * (1 - lx)),
                       (y0, x0 + 1, (1 - ly) * lx),
                       (y0 + 1, x0, ly * (1 - lx)),
                       (y0 + 1, x0 + 1, ly * lx)):
        inb = (yy >= 0) & (yy < fh) & (xx >= 0) & (xx < fw)
        lin = (yy.clamp(0, fh - 1) * fw + xx.clamp(0, fw - 1)).to(
            torch.int64).reshape(n, 1, -1).expand(n, c, -1)
        v = torch.gather(flat, 2, lin).reshape((n, c) + tuple(py.shape[1:]))
        out = out + torch.where(inb[:, None], v, 0.0) * wt[:, None]
    return out


@register_op("deform_conv2d")
def _deform_conv2d(x, offset, weight, mask=None, bias=None, stride=1,
                   padding=0, dilation=1, deformable_groups=1, groups=1):
    """Deformable convolution (v1; v2 with ``mask``): each kernel tap
    samples ``x`` at its offset position (bilinear, zero outside), then
    one product contracts taps x input channels against ``weight``."""
    st, pd, dl = _pair(stride), _pair(padding), _pair(dilation)
    n, cin, h, w = x.shape
    cout, cin_g, kh, kw = weight.shape
    oh = (h + 2 * pd[0] - dl[0] * (kh - 1) - 1) // st[0] + 1
    ow = (w + 2 * pd[1] - dl[1] * (kw - 1) - 1) // st[1] + 1
    dev = x.device
    xf = x.float()
    dg = deformable_groups
    offs = offset.float().reshape(n, dg, kh * kw, 2, oh, ow)
    base_y = (torch.arange(oh, device=dev) * st[0] - pd[0])[:, None] \
        + (torch.arange(kh, device=dev) * dl[0])[None, :]        # [oh, kh]
    base_x = (torch.arange(ow, device=dev) * st[1] - pd[1])[:, None] \
        + (torch.arange(kw, device=dev) * dl[1])[None, :]        # [ow, kw]
    ys = base_y.t()[:, None, :, None].expand(kh, kw, oh, ow).reshape(
        kh * kw, oh, ow).float()
    xs = base_x.t()[None, :, None, :].expand(kh, kw, oh, ow).reshape(
        kh * kw, oh, ow).float()
    cpd = cin // dg
    masks = None if mask is None else mask.float().reshape(
        n, dg, kh * kw, oh, ow)
    vals = []
    for g in range(dg):
        v = _bilinear_zero(xf[:, g * cpd:(g + 1) * cpd],
                           ys[None] + offs[:, g, :, 0],
                           xs[None] + offs[:, g, :, 1])   # [N, C/dg, K, ...]
        if masks is not None:
            v = v * masks[:, g, None]
        vals.append(v)
    sampled = torch.cat(vals, dim=1)                       # [N, C, K, oh, ow]
    wf = weight.float().reshape(groups, cout // groups, cin_g, kh * kw)
    sg = sampled.reshape(n, groups, cin // groups, kh * kw, oh, ow)
    out = torch.einsum("gock,ngckyx->ngoyx", wf, sg).reshape(n, cout, oh,
                                                             ow)
    if bias is not None:
        out = out + bias.float().reshape(1, -1, 1, 1)
    return out.to(x.dtype)


@register_op("yolo_box")
def _yolo_box(x, img_size, anchors=(), class_num=1, conf_thresh=0.01,
              downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
              iou_aware=False, iou_aware_factor=0.5):
    """Decode a YOLOv3 head ``[N, A * (5 + classes), H, W]`` into boxes
    ``[N, A * H * W, 4]`` (xyxy in image pixels) and scores ``[N, A * H *
    W, classes]`` (0 where the objectness is at most ``conf_thresh``),
    float32."""
    anchors = list(anchors)
    na = len(anchors) // 2
    n, _, h, w = x.shape
    dev = x.device
    xf = x.float().reshape(n, na, 5 + class_num, h, w)
    grid_x = torch.arange(w, device=dev, dtype=torch.float32)
    grid_y = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    aw = torch.tensor(anchors[0::2], dtype=torch.float32,
                      device=dev)[None, :, None, None]
    ah = torch.tensor(anchors[1::2], dtype=torch.float32,
                      device=dev)[None, :, None, None]
    input_h, input_w = downsample_ratio * h, downsample_ratio * w
    bx = _div(torch.sigmoid(xf[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2
              + grid_x, w)
    by = _div(torch.sigmoid(xf[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2
              + grid_y, h)
    bw = _div(torch.exp(xf[:, :, 2]) * aw, input_w)
    bh = _div(torch.exp(xf[:, :, 3]) * ah, input_h)
    conf = torch.sigmoid(xf[:, :, 4])
    probs = torch.sigmoid(xf[:, :, 5:]) * conf[:, :, None]
    img_h = img_size.float()[:, 0][:, None, None, None]
    img_w = img_size.float()[:, 1][:, None, None, None]
    x1 = (bx - bw / 2) * img_w
    y1 = (by - bh / 2) * img_h
    x2 = (bx + bw / 2) * img_w
    y2 = (by + bh / 2) * img_h
    if clip_bbox:
        x1, y1 = x1.clamp(min=0), y1.clamp(min=0)
        x2 = torch.minimum(x2, img_w - 1)
        y2 = torch.minimum(y2, img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(n, -1, 4)
    keep = (conf > conf_thresh)[..., None]
    scores = torch.where(keep, probs.permute(0, 1, 3, 4, 2), 0.0).reshape(
        n, -1, class_num)
    return boxes, scores


def _bce(logit, target):
    return logit.clamp(min=0) - logit * target \
        + torch.log1p(torch.exp(-logit.abs()))


def _last_writer(flat_index, size):
    """For each of ``flat_index``'s entries, whether it is the last one
    writing its target (one writer a cell, as a serial scatter leaves
    it), on the device."""
    order = torch.arange(flat_index.numel(), device=flat_index.device)
    last = torch.full((size,), -1, dtype=order.dtype,
                      device=flat_index.device)
    last.scatter_reduce_(0, flat_index, order, reduce="amax")
    return last[flat_index] == order


@register_op("yolo_loss")
def _yolo_loss(x, gt_box, gt_label, gt_score=None, anchors=(),
               anchor_mask=(), class_num=1, ignore_thresh=0.7,
               downsample_ratio=32, use_label_smooth=True, scale_x_y=1.0):
    """The YOLOv3 loss of one head ``x [N, A * (5 + classes), H, W]``
    against ``gt_box [N, B, 4]`` (cx, cy, w, h over the image),
    ``gt_label [N, B]``: the coordinate BCE / L1 terms on each box's
    responsible anchor, the objectness BCE with the ignore region, the
    class BCE (the JAX op, term for term). Returns ``[N]``. A cell that
    two boxes claim takes the later box's targets."""
    anchors, anchor_mask = list(anchors), list(anchor_mask)
    n, _, h, w = x.shape
    na = len(anchor_mask)
    dev = x.device
    f32 = torch.float32
    xf = x.float().reshape(n, na, 5 + class_num, h, w)
    input_size = downsample_ratio * h
    gt = gt_box.float()
    nb = gt.shape[1]
    all_aw = _div(torch.tensor(anchors[0::2], dtype=f32, device=dev),
                  input_size)
    all_ah = _div(torch.tensor(anchors[1::2], dtype=f32, device=dev),
                  input_size)
    gw, gh = gt[..., 2][..., None], gt[..., 3][..., None]
    inter = torch.minimum(gw, all_aw) * torch.minimum(gh, all_ah)
    iou_a = inter / (gw * all_ah * 0 + gw * gh + all_aw * all_ah - inter
                     + 1e-10)
    best_a = torch.argmax(iou_a, dim=-1)                        # [N, B]
    gi = (gt[..., 0] * w).to(torch.int32).clamp(0, w - 1).long()
    gj = (gt[..., 1] * h).to(torch.int32).clamp(0, h - 1).long()
    valid = (gt[..., 2] > 0) & (gt[..., 3] > 0)

    px = torch.sigmoid(xf[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2
    py = torch.sigmoid(xf[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2
    pw, ph, pobj, pcls = xf[:, :, 2], xf[:, :, 3], xf[:, :, 4], xf[:, :, 5:]

    mask_aw = torch.tensor([anchors[2 * m] for m in anchor_mask], dtype=f32,
                           device=dev)[None, :, None, None]
    mask_ah = torch.tensor([anchors[2 * m + 1] for m in anchor_mask],
                           dtype=f32, device=dev)[None, :, None, None]
    bx = _div(px + torch.arange(w, dtype=f32, device=dev), w)
    by = _div(py + torch.arange(h, dtype=f32, device=dev)[:, None], h)
    bw = _div(torch.exp(pw) * mask_aw, input_size)
    bh = _div(torch.exp(ph) * mask_ah, input_size)
    px1, py1, px2, py2 = bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2
    g5 = (slice(None), slice(None), None, None, None)
    gx1 = (gt[..., 0] - gt[..., 2] / 2)[g5]
    gy1 = (gt[..., 1] - gt[..., 3] / 2)[g5]
    gx2 = (gt[..., 0] + gt[..., 2] / 2)[g5]
    gy2 = (gt[..., 1] + gt[..., 3] / 2)[g5]
    ix1 = torch.maximum(px1[:, None], gx1)
    iy1 = torch.maximum(py1[:, None], gy1)
    ix2 = torch.minimum(px2[:, None], gx2)
    iy2 = torch.minimum(py2[:, None], gy2)
    inter_p = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    area_p = (px2 - px1) * (py2 - py1)
    area_g = (gx2 - gx1) * (gy2 - gy1)
    iou_p = inter_p / (area_p[:, None] + area_g - inter_p + 1e-10)
    iou_p = torch.where(valid[g5], iou_p, 0.0)
    ignore = iou_p.amax(1) > ignore_thresh                     # [N, A, H, W]

    am = torch.tensor(anchor_mask, device=dev)
    hit = best_a[..., None] == am
    in_layer = hit.any(-1) & valid
    a_local = torch.argmax(hit.to(torch.int32), dim=-1)
    sel_aw, sel_ah = all_aw[best_a], all_ah[best_a]
    score = torch.ones((n, nb), dtype=f32, device=dev) if gt_score is None \
        else gt_score.float()
    wgt = torch.where(in_layer, score, 0.0)
    # rows not in this layer write to a spare image n, which is dropped
    bi = torch.where(in_layer, torch.arange(n, device=dev)[:, None], n)
    cell = ((bi * na + a_local) * h + gj) * w + gi              # [N, B]
    cells = (n + 1) * na * h * w
    cell, wgt_f = cell.reshape(-1), wgt.reshape(-1)
    writer = _last_writer(cell, cells)
    put = torch.where(writer, cell, cells)           # losers: a dump slot

    def scatter_set(vals):
        out = torch.zeros(cells + 1, dtype=f32, device=dev)
        out.scatter_(0, put, torch.where(in_layer, vals, 0.0).reshape(-1))
        return out[:n * na * h * w].reshape(n, na, h, w)

    obj_t = torch.zeros(cells, dtype=f32, device=dev).scatter_reduce(
        0, cell, wgt_f, reduce="amax")[:n * na * h * w].reshape(n, na, h, w)
    tx = scatter_set(gt[..., 0] * w - gi)
    ty = scatter_set(gt[..., 1] * h - gj)
    tw = scatter_set(torch.log((gt[..., 2] / sel_aw).clamp(min=1e-9)))
    th = scatter_set(torch.log((gt[..., 3] / sel_ah).clamp(min=1e-9)))
    tscale = scatter_set(2.0 - gt[..., 2] * gt[..., 3])
    smooth = 1.0 / class_num if use_label_smooth and class_num > 1 else 0.0
    onehot = torch.nn.functional.one_hot(gt_label.long(), class_num).to(f32)
    cls_val = (onehot * (1.0 - 2 * smooth) + smooth) * \
        in_layer.to(f32)[..., None]                             # [N, B, K]
    k = torch.arange(class_num, device=dev)
    cls_cell = (((bi * na + a_local)[..., None] * class_num + k) * h
                + gj[..., None]) * w + gi[..., None]
    cls_t = torch.zeros((n + 1) * na * class_num * h * w, dtype=f32,
                        device=dev).scatter_reduce(
        0, cls_cell.reshape(-1), cls_val.reshape(-1), reduce="amax")
    cls_t = cls_t[:n * na * class_num * h * w].reshape(n, na, class_num, h,
                                                        w)
    pos = obj_t > 0
    loss_xy = torch.where(pos, tscale * obj_t * (
        _bce(xf[:, :, 0], tx) + _bce(xf[:, :, 1], ty)), 0.0).sum((1, 2, 3))
    loss_wh = torch.where(pos, tscale * obj_t * (
        (pw - tw).abs() + (ph - th).abs()), 0.0).sum((1, 2, 3))
    obj_loss = _bce(pobj, pos.to(f32))
    loss_obj = torch.where(pos, obj_t * obj_loss, torch.where(
        ignore, 0.0, obj_loss)).sum((1, 2, 3))
    loss_cls = torch.where(pos[:, :, None], obj_t[:, :, None] * _bce(
        pcls, cls_t), 0.0).sum((1, 2, 3, 4))
    return (loss_xy + loss_wh + loss_obj + loss_cls).to(x.dtype)
