"""``vision.ops``: the detection ops (counterpart of
``paddle_tpu/vision/ops.py``; reference: python/paddle/vision/ops.py).

The functional forms and layers over the ops of
``paddle_tpu_torch/ops/vision_ops.py`` (``roi_align``, ``roi_pool``,
``psroi_pool``, ``nms``, ``deform_conv2d``, ``yolo_box``,
``yolo_loss``), ``matrix_nms`` (``ops/linalg_ops.py``), and the host-side
``read_file`` / ``decode_jpeg`` (PIL, imported at the first decode).
Every op runs on its inputs' device; a region op's ``boxes_num`` is read
on the host, since the boxes' layout over the images shapes the work.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import nn
from ..framework.dispatch import call_op as _op

__all__ = ["yolo_box", "yolo_loss", "deform_conv2d", "DeformConv2D",
           "psroi_pool", "PSRoIPool", "roi_pool", "RoIPool", "roi_align",
           "RoIAlign", "nms", "matrix_nms", "read_file", "decode_jpeg"]


def _counts(boxes_num):
    bn = boxes_num.detach().cpu().numpy() \
        if isinstance(boxes_num, torch.Tensor) else boxes_num
    return tuple(int(v) for v in np.asarray(bn).reshape(-1))


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    return _op("roi_align", x, boxes, output_size=output_size,
               spatial_scale=spatial_scale, sampling_ratio=sampling_ratio,
               aligned=aligned, boxes_num=_counts(boxes_num))


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    return _op("roi_pool", x, boxes, output_size=output_size,
               spatial_scale=spatial_scale, boxes_num=_counts(boxes_num))


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    return _op("psroi_pool", x, boxes, output_size=output_size,
               spatial_scale=spatial_scale, boxes_num=_counts(boxes_num))


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Hard NMS on the boxes' device: the kept indices in score order.
    With ``category_idxs``, boxes suppress only their own category's and
    only the listed ``categories`` are kept, ordered by score (the JAX
    categorical form, which runs one NMS a category on the host)."""
    if category_idxs is None:
        return _op("nms", boxes, scores, iou_threshold=iou_threshold,
                   top_k=top_k)
    if categories is None:
        raise ValueError("nms: category_idxs needs categories")
    return _op("nms", boxes, scores, iou_threshold=iou_threshold,
               top_k=top_k, category_idxs=category_idxs,
               categories=tuple(int(c) for c in categories))


def matrix_nms(bboxes, scores, score_threshold, post_threshold, nms_top_k,
               keep_top_k, use_gaussian=False, gaussian_sigma=2.0,
               background_label=0, normalized=True, return_index=False,
               return_rois_num=True, name=None):
    """Matrix NMS: score-decay suppression (SOLOv2) over [N, M, 4] boxes
    and [N, C, M] scores. Out rows are [label, score, x1, y1, x2, y2].
    Reference: python/paddle/fluid/layers/detection.py:3573."""
    out, index, rois_num = _op(
        "matrix_nms", bboxes, scores, score_threshold=score_threshold,
        post_threshold=post_threshold, nms_top_k=nms_top_k,
        keep_top_k=keep_top_k, use_gaussian=use_gaussian,
        gaussian_sigma=gaussian_sigma, background_label=background_label,
        normalized=normalized)
    res = [out]
    if return_rois_num:
        res.append(rois_num)
    if return_index:
        res.append(index)
    return tuple(res) if len(res) > 1 else out


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    return _op("deform_conv2d", x, offset, weight, mask, bias,
               stride=stride, padding=padding, dilation=dilation,
               deformable_groups=deformable_groups, groups=groups)


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, name=None, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    return _op("yolo_box", x, img_size, anchors=tuple(anchors),
               class_num=class_num, conf_thresh=conf_thresh,
               downsample_ratio=downsample_ratio, clip_bbox=clip_bbox,
               scale_x_y=scale_x_y)


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    return _op("yolo_loss", x, gt_box, gt_label, gt_score,
               anchors=tuple(anchors), anchor_mask=tuple(anchor_mask),
               class_num=class_num, ignore_thresh=ignore_thresh,
               downsample_ratio=downsample_ratio,
               use_label_smooth=use_label_smooth, scale_x_y=scale_x_y)


class RoIAlign(nn.Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._o, self._s = output_size, spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self._o, self._s)


class RoIPool(nn.Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._o, self._s = output_size, spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self._o, self._s)


class PSRoIPool(nn.Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._o, self._s = output_size, spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self._o, self._s)


class DeformConv2D(nn.Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        ks = (kernel_size, kernel_size) if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self._attrs = dict(stride=stride, padding=padding, dilation=dilation,
                           deformable_groups=deformable_groups,
                           groups=groups)
        from ..nn.initializer import XavierUniform
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *ks], attr=weight_attr,
            default_initializer=XavierUniform())
        self.bias = self.create_parameter([out_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias,
                             mask=mask, **self._attrs)


def read_file(filename, name=None):
    """The file's bytes as a uint8 CPU tensor (reference
    ``vision/ops.py`` ``read_file``)."""
    with open(filename, "rb") as f:
        data = f.read()
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy())


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode JPEG bytes (a uint8 tensor or array) to a CHW uint8 CPU
    tensor (reference ``vision/ops.py`` ``decode_jpeg``; PIL here).
    ``"unchanged"`` keeps the stored channels (a grayscale JPEG stays
    ``[1, H, W]``), ``"gray"`` and ``"rgb"`` convert."""
    import io

    from PIL import Image
    arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
    img = Image.open(io.BytesIO(bytes(np.asarray(arr, np.uint8))))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb" and img.mode != "RGB":
        img = img.convert("RGB")
    out = np.asarray(img, np.uint8)
    out = out[None] if out.ndim == 2 else out.transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(out))
