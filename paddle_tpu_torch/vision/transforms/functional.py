"""Functional image ops (counterpart of
``paddle_tpu/vision/transforms/functional.py``; reference:
python/paddle/vision/transforms/functional.py + functional_cv2.py).

Numpy on the host, CHW float (channels-first, as the datasets give it),
so that a loader's worker processes touch neither the card nor CUDA. No
PIL or cv2: resize is bilinear, the geometric warps (rotate, affine,
perspective) are inverse-mapped with nearest sampling. A torch tensor
may come in wherever an array may; ``to_tensor`` gives a CPU tensor
(the loader's prefetch, or the caller, moves batches to the card).
"""
from __future__ import annotations

import math
import numbers

import numpy as np
import torch

__all__ = ["to_tensor", "resize", "crop", "center_crop", "hflip",
           "vflip", "pad", "normalize", "rotate", "affine",
           "perspective", "erase", "adjust_brightness",
           "adjust_contrast", "adjust_saturation", "adjust_hue",
           "to_grayscale"]


def _chw(img):
    if isinstance(img, torch.Tensor):      # e.g. ToTensor's output
        img = img.detach().cpu().numpy()
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[None]
    elif arr.ndim == 3 and arr.shape[-1] in (1, 3, 4) and \
            arr.shape[0] not in (1, 3, 4):
        arr = arr.transpose(2, 0, 1)
    return arr


def to_tensor(pic, data_format="CHW"):
    """A float32 CPU tensor (the reference contract: ``to_tensor`` is the
    pipeline step that leaves numpy); uint8 inputs scale to [0, 1]."""
    arr = _chw(pic)
    is_uint8 = arr.dtype == np.uint8
    arr = arr.astype(np.float32)
    if is_uint8:  # dtype decides, not value range: float inputs pass
        arr = arr / 255.0
    if data_format == "HWC":
        arr = arr.transpose(1, 2, 0)
    return torch.from_numpy(np.ascontiguousarray(arr))


def resize(img, size, interpolation="bilinear"):
    """Bilinear (default) or nearest resize; ``size`` int means the
    SHORTER side scales to it, keeping aspect (reference semantics)."""
    img = _chw(np.asarray(img, np.float32))
    c, h, w = img.shape
    if isinstance(size, numbers.Number):
        if h <= w:
            nh, nw = int(size), max(1, int(round(w * size / h)))
        else:
            nh, nw = max(1, int(round(h * size / w))), int(size)
    else:
        nh, nw = int(size[0]), int(size[1])
    if interpolation == "nearest":
        ri = np.minimum((np.arange(nh) + 0.5) * h / nh, h - 1).astype(int)
        ci = np.minimum((np.arange(nw) + 0.5) * w / nw, w - 1).astype(int)
        return img[:, ri][:, :, ci]
    # bilinear, align_corners=False
    ys = (np.arange(nh) + 0.5) * h / nh - 0.5
    xs = (np.arange(nw) + 0.5) * w / nw - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[None, :, None]
    wx = np.clip(xs - x0, 0, 1)[None, None, :]
    tl = img[:, y0][:, :, x0]
    tr = img[:, y0][:, :, x1]
    bl = img[:, y1][:, :, x0]
    br = img[:, y1][:, :, x1]
    top = tl * (1 - wx) + tr * wx
    bot = bl * (1 - wx) + br * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def crop(img, top, left, height, width):
    img = _chw(img)
    return img[:, top:top + height, left:left + width]


def center_crop(img, output_size):
    img = _chw(img)
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    th, tw = output_size
    _, h, w = img.shape
    return crop(img, max(0, (h - th) // 2), max(0, (w - tw) // 2), th, tw)


def hflip(img):
    return _chw(img)[:, :, ::-1].copy()


def vflip(img):
    return _chw(img)[:, ::-1].copy()


def pad(img, padding, fill=0, padding_mode="constant"):
    img = _chw(img)
    if isinstance(padding, numbers.Number):
        l = t = r = b = int(padding)
    elif len(padding) == 2:
        l, t = padding
        r, b = l, t
    else:
        l, t, r, b = padding
    spec = [(0, 0), (t, b), (l, r)]
    if padding_mode == "constant":
        return np.pad(img, spec, constant_values=fill)
    mode = {"edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    return np.pad(img, spec, mode=mode)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    is_tensor = isinstance(img, torch.Tensor)
    if is_tensor:
        img = img.detach().cpu().numpy()
    arr = np.asarray(img, np.float32)
    shape = (-1, 1, 1) if data_format == "CHW" else (1, 1, -1)
    mean = np.asarray(mean, np.float32).reshape(shape)
    std = np.asarray(std, np.float32).reshape(shape)
    out = (arr - mean) / std
    if is_tensor:  # Tensor in -> Tensor out (reference semantics)
        return torch.from_numpy(out.astype(np.float32))
    return out


def _inverse_sample(img, inv, fill=0.0):
    """Sample at inv-mapped coords on the SAME-size canvas."""
    return _inverse_sample_sized(img, inv, img.shape[1:], fill)


def _inverse_sample_sized(img, inv, out_hw, fill=0.0):
    """Sample ``img`` [C,H,W] at inv-mapped output coords (nearest);
    ``inv`` maps output (x, y, 1) -> source (x, y). Out-of-range
    pixels take ``fill``."""
    c, h, w = img.shape
    oh, ow = out_hw
    ys, xs = np.mgrid[0:oh, 0:ow].astype(np.float32)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    if inv.shape[0] == 3:                      # projective division
        d = inv[2, 0] * xs + inv[2, 1] * ys + inv[2, 2]
        d = np.where(np.abs(d) < 1e-8, 1e-8, d)
        sx, sy = sx / d, sy / d
    xi = np.round(sx).astype(int)
    yi = np.round(sy).astype(int)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    xi = np.clip(xi, 0, w - 1)
    yi = np.clip(yi, 0, h - 1)
    out = img[:, yi, xi]
    return np.where(valid[None], out, np.float32(fill))


def _affine_matrix(angle, translate, scale, shear, center):
    """Forward output<-source matrix per the reference's parameter
    convention; returns the INVERSE for sampling."""
    rot = math.radians(angle)
    sx, sy = (math.radians(s) for s in shear)
    cx, cy = center
    tx, ty = translate
    # forward: translate(center+t) . rot/shear/scale . translate(-center)
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    m = np.array([[a * scale, b * scale, 0.0],
                  [c * scale, d * scale, 0.0],
                  [0.0, 0.0, 1.0]], np.float32)
    pre = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float32)
    post = np.array([[1, 0, cx + tx], [0, 1, cy + ty], [0, 0, 1]],
                    np.float32)
    fwd = post @ m @ pre
    return np.linalg.inv(fwd)


def rotate(img, angle, interpolation="nearest", expand=False,
           center=None, fill=0):
    img = _chw(np.asarray(img, np.float32))
    c, h, w = img.shape
    if center is None:
        center = ((w - 1) / 2.0, (h - 1) / 2.0)
    inv = _affine_matrix(-angle, (0, 0), 1.0, (0.0, 0.0), center)
    if not expand:
        return _inverse_sample(img, inv, fill)
    # expand: enlarge the canvas to hold every rotated source corner
    rad = math.radians(angle)
    nw = int(math.ceil(abs(w * math.cos(rad)) + abs(h * math.sin(rad))))
    nh = int(math.ceil(abs(h * math.cos(rad)) + abs(w * math.sin(rad))))
    # recenter: output center maps to the source center
    fwd_shift = np.array([[1, 0, (nw - 1) / 2.0 - center[0]],
                          [0, 1, (nh - 1) / 2.0 - center[1]],
                          [0, 0, 1]], np.float32)
    inv_big = inv @ np.linalg.inv(fwd_shift)
    return _inverse_sample_sized(img, inv_big, (nh, nw), fill)


def affine(img, angle=0, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
           interpolation="nearest", fill=0, center=None):
    img = _chw(np.asarray(img, np.float32))
    _, h, w = img.shape
    if isinstance(shear, numbers.Number):
        shear = (float(shear), 0.0)
    if center is None:
        center = ((w - 1) / 2.0, (h - 1) / 2.0)
    inv = _affine_matrix(-angle, translate, scale, shear, center)
    return _inverse_sample(img, inv, fill)


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """Warp so ``startpoints`` (4 corner [x, y]) land on ``endpoints``."""
    img = _chw(np.asarray(img, np.float32))
    a, bvec = [], []
    # solve the homography destination -> source (the inverse map)
    for (sx, sy), (dx, dy) in zip(startpoints, endpoints):
        a.append([dx, dy, 1, 0, 0, 0, -sx * dx, -sx * dy])
        a.append([0, 0, 0, dx, dy, 1, -sy * dx, -sy * dy])
        bvec += [sx, sy]
    sol, *_ = np.linalg.lstsq(np.asarray(a, np.float32),
                              np.asarray(bvec, np.float32), rcond=None)
    inv = np.append(sol, 1.0).reshape(3, 3).astype(np.float32)
    return _inverse_sample(img, inv, fill)


def erase(img, i, j, h, w, v, inplace=False):
    arr = _chw(np.asarray(img, np.float32))
    if not inplace:
        arr = arr.copy()
    arr[:, i:i + h, j:j + w] = v
    return arr


def to_grayscale(img, num_output_channels=1):
    arr = _chw(np.asarray(img, np.float32))
    if arr.shape[0] == 3:
        gray = (0.299 * arr[0] + 0.587 * arr[1] + 0.114 * arr[2])[None]
    else:
        gray = arr[:1]
    return np.repeat(gray, num_output_channels, axis=0)


def adjust_brightness(img, brightness_factor):
    return np.asarray(img, np.float32) * float(brightness_factor)


def adjust_contrast(img, contrast_factor):
    arr = _chw(np.asarray(img, np.float32))
    mean = to_grayscale(arr, 1).mean()
    return (arr - mean) * float(contrast_factor) + mean


def adjust_saturation(img, saturation_factor):
    arr = _chw(np.asarray(img, np.float32))
    gray = to_grayscale(arr, arr.shape[0])
    return gray + (arr - gray) * float(saturation_factor)


def adjust_hue(img, hue_factor):
    """Shift hue by ``hue_factor`` (in [-0.5, 0.5] turns) via vectorized
    RGB->HSV->RGB (reference functional adjust_hue semantics)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError(f"hue_factor must be in [-0.5, 0.5], "
                         f"got {hue_factor}")
    arr = _chw(np.asarray(img, np.float32))
    if arr.shape[0] != 3:
        return arr
    scale = 255.0 if arr.max() > 1.5 else 1.0
    r, g, b = arr / scale
    mx = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    delta = mx - mn
    safe = np.where(delta == 0, 1.0, delta)
    hue = np.where(mx == r, (g - b) / safe % 6,
                   np.where(mx == g, (b - r) / safe + 2,
                            (r - g) / safe + 4)) / 6.0
    hue = np.where(delta == 0, 0.0, hue)
    sat = np.where(mx == 0, 0.0, delta / np.where(mx == 0, 1.0, mx))
    hue = (hue + hue_factor) % 1.0
    # HSV -> RGB
    i = np.floor(hue * 6.0)
    f = hue * 6.0 - i
    p = mx * (1 - sat)
    q = mx * (1 - sat * f)
    t = mx * (1 - sat * (1 - f))
    i = i.astype(int) % 6
    r2 = np.choose(i, [mx, q, p, p, t, mx])
    g2 = np.choose(i, [t, mx, mx, q, p, p])
    b2 = np.choose(i, [p, p, t, mx, mx, q])
    return np.stack([r2, g2, b2]) * scale
