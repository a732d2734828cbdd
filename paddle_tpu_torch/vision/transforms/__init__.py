"""Vision transforms (counterpart of
``paddle_tpu/vision/transforms/__init__.py``; reference:
python/paddle/vision/transforms/).

Numpy transforms on the host in CHW float layout. The random ones draw
from :func:`rng`: one ``numpy.random.RandomState`` a process, seeded
from ``torch.initial_seed()`` when the process first draws (a
``DataLoader`` worker gets its own torch seed, so each worker draws its
own stream, reproducibly for a given base seed). ``seed(n)`` reseeds the
calling process's.
"""
from __future__ import annotations

import numbers
import os

import numpy as np
import torch

from . import functional  # noqa: F401
from .functional import (  # noqa: F401
    adjust_brightness, adjust_contrast, adjust_hue, adjust_saturation,
    affine, center_crop, crop, erase, hflip, normalize, pad, perspective,
    resize, rotate, to_grayscale, to_tensor, vflip,
)

_RNG = [None, None]          # (pid, RandomState) of the drawing process


def rng():
    """The ``numpy.random.RandomState`` the random transforms of this
    process draw from (made anew in a forked child, from its torch
    seed)."""
    if _RNG[0] != os.getpid():
        _RNG[:] = [os.getpid(), np.random.RandomState(
            torch.initial_seed() % (1 << 32))]
    return _RNG[1]


def seed(value):
    """Reseed this process's transform generator (:func:`rng`)."""
    _RNG[:] = [os.getpid(), np.random.RandomState(int(value) % (1 << 32))]


__all__ = ["Compose", "BaseTransform", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomCrop", "RandomHorizontalFlip",
           "RandomVerticalFlip", "Transpose", "BrightnessTransform",
           "ContrastTransform", "SaturationTransform", "HueTransform",
           "ColorJitter", "Grayscale", "Pad", "RandomRotation",
           "RandomAffine", "RandomPerspective", "RandomErasing",
           "RandomResizedCrop",
           # functional forms (reference transforms/functional.py)
           "to_tensor", "resize", "crop", "center_crop", "hflip",
           "vflip", "pad", "normalize", "rotate", "affine",
           "perspective", "erase", "adjust_brightness",
           "adjust_contrast", "adjust_saturation", "adjust_hue",
           "to_grayscale"]


class BaseTransform:
    """Reference transforms.BaseTransform: subclasses implement
    ``_apply_image`` (and optionally ``_get_params``); __call__ routes
    tuple inputs by ``keys`` — only "image" entries go through
    ``_apply_image``, everything else (labels, boxes) passes through
    untouched, exactly so targets are never color-jittered."""

    def __init__(self, keys=None):
        self.keys = tuple(keys) if keys is not None else ("image",)

    def _get_params(self, inputs):
        return None

    def _apply_image(self, img):
        raise NotImplementedError

    def __call__(self, inputs):
        self.params = self._get_params(inputs)
        if isinstance(inputs, (list, tuple)):
            keys = self.keys + ("image",) * (len(inputs) - len(self.keys))
            return type(inputs)(
                self._apply_image(v) if k == "image" else v
                for k, v in zip(keys, inputs))
        return self._apply_image(inputs)


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class ToTensor:
    """HWC uint8 -> CHW float32 in [0,1]; CHW input passes through scaled."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        return functional.to_tensor(img, self.data_format)


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean, self.std = mean, std
        self.data_format = data_format

    def __call__(self, img):
        return functional.normalize(img, self.mean, self.std,
                                    self.data_format)


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.asarray(img).transpose(self.order)


class Resize:
    """functional.resize semantics (reference Resize): int size scales
    the SHORTER side keeping aspect; real bilinear by default."""

    def __init__(self, size, interpolation="bilinear"):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, img):
        return functional.resize(img, self.size, self.interpolation)


class CenterCrop:
    def __init__(self, size):
        self.size = size

    def __call__(self, img):
        return functional.center_crop(img, self.size)


class RandomCrop:
    def __init__(self, size, padding=None):
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.padding = padding

    def __call__(self, img):
        img = functional._chw(img)
        if self.padding:
            img = functional.pad(img, self.padding)
        c, h, w = img.shape
        th, tw = self.size
        i = rng().randint(0, h - th + 1)
        j = rng().randint(0, w - tw + 1)
        return img[:, i:i + th, j:j + tw]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        img = functional._chw(img)  # layout must not depend on the coin
        if rng().rand() < self.prob:
            return functional.hflip(img)
        return img


class RandomVerticalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        img = functional._chw(img)  # layout must not depend on the coin
        if rng().rand() < self.prob:
            return functional.vflip(img)
        return img


class BrightnessTransform:
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        alpha = rng().uniform(max(0.0, 1 - self.value),
                                  1 + self.value)
        return functional._chw(img).astype(np.float32) * alpha


class Pad:
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding, self.fill = padding, fill
        self.padding_mode = padding_mode

    def __call__(self, img):
        return functional.pad(img, self.padding, self.fill,
                              self.padding_mode)


class ContrastTransform:
    """Random contrast in [1-value, 1+value] (reference
    transforms.ContrastTransform)."""

    def __init__(self, value):
        self.value = float(value)

    def __call__(self, img):
        f = rng().uniform(max(0.0, 1 - self.value), 1 + self.value)
        return functional.adjust_contrast(img, f)


class SaturationTransform:
    def __init__(self, value):
        self.value = float(value)

    def __call__(self, img):
        f = rng().uniform(max(0.0, 1 - self.value), 1 + self.value)
        return functional.adjust_saturation(img, f)


class HueTransform:
    def __init__(self, value):
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = float(value)

    def __call__(self, img):
        f = rng().uniform(-self.value, self.value)
        return functional.adjust_hue(img, f)


class ColorJitter:
    """Random brightness/contrast/saturation/hue in random order
    (reference transforms.ColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.transforms = []
        if brightness:
            self.transforms.append(BrightnessTransform(brightness))
        if contrast:
            self.transforms.append(ContrastTransform(contrast))
        if saturation:
            self.transforms.append(SaturationTransform(saturation))
        if hue:
            self.transforms.append(HueTransform(hue))

    def __call__(self, img):
        order = rng().permutation(len(self.transforms))
        for i in order:
            img = self.transforms[i](img)
        return img


class Grayscale:
    def __init__(self, num_output_channels=1):
        self.num_output_channels = num_output_channels

    def __call__(self, img):
        return functional.to_grayscale(img, self.num_output_channels)


class RandomRotation:
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0):
        if isinstance(degrees, numbers.Number):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.center, self.fill = center, fill

    def __call__(self, img):
        angle = rng().uniform(*self.degrees)
        return functional.rotate(img, angle, center=self.center,
                                 fill=self.fill)


class RandomAffine:
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None):
        if isinstance(degrees, numbers.Number):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.translate, self.scale_rng = translate, scale
        self.shear, self.fill, self.center = shear, fill, center

    def __call__(self, img):
        img = functional._chw(img)
        h, w = img.shape[-2:]
        angle = rng().uniform(*self.degrees)
        tx = ty = 0.0
        if self.translate is not None:
            tx = rng().uniform(-self.translate[0], self.translate[0]) * w
            ty = rng().uniform(-self.translate[1], self.translate[1]) * h
        scale = rng().uniform(*self.scale_rng) if self.scale_rng \
            else 1.0
        shear = (0.0, 0.0)
        if self.shear is not None:
            s = self.shear
            if isinstance(s, numbers.Number):
                s = (-abs(s), abs(s))
            shear = (rng().uniform(s[0], s[1]), 0.0)
        return functional.affine(img, angle, (tx, ty), scale, shear,
                                 fill=self.fill, center=self.center)


class RandomPerspective:
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0):
        self.prob, self.scale, self.fill = prob, distortion_scale, fill

    def __call__(self, img):
        img = functional._chw(img)  # layout must not depend on the coin
        if rng().rand() >= self.prob:
            return img
        h, w = img.shape[-2:]
        dx, dy = self.scale * w / 2, self.scale * h / 2
        start = [[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]]
        end = [[rng().uniform(0, dx), rng().uniform(0, dy)],
               [w - 1 - rng().uniform(0, dx),
                rng().uniform(0, dy)],
               [w - 1 - rng().uniform(0, dx),
                h - 1 - rng().uniform(0, dy)],
               [rng().uniform(0, dx),
                h - 1 - rng().uniform(0, dy)]]
        return functional.perspective(img, start, end, fill=self.fill)


class RandomErasing:
    """Random rectangle erase (reference transforms.RandomErasing)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False):
        self.prob, self.scale, self.ratio = prob, scale, ratio
        self.value, self.inplace = value, inplace

    def __call__(self, img):
        img = functional._chw(img).astype(np.float32)
        if rng().rand() >= self.prob:
            return img
        c, h, w = img.shape
        for _ in range(10):
            area = h * w * rng().uniform(*self.scale)
            ar = np.exp(rng().uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            eh = int(round(np.sqrt(area * ar)))
            ew = int(round(np.sqrt(area / ar)))
            if eh < h and ew < w:
                i = rng().randint(0, h - eh + 1)
                j = rng().randint(0, w - ew + 1)
                v = rng().randn(c, eh, ew).astype(np.float32) \
                    if self.value == "random" else self.value
                return functional.erase(img, i, j, eh, ew, v,
                                        inplace=self.inplace)
        return img


class RandomResizedCrop:
    """Random area/aspect crop resized to ``size`` (reference
    transforms.RandomResizedCrop — the ImageNet training transform)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size, self.scale, self.ratio = size, scale, ratio
        self.interpolation = interpolation

    def __call__(self, img):
        img = functional._chw(img).astype(np.float32)
        c, h, w = img.shape
        for _ in range(10):
            area = h * w * rng().uniform(*self.scale)
            ar = np.exp(rng().uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            ch = int(round(np.sqrt(area / ar)))
            cw = int(round(np.sqrt(area * ar)))
            if 0 < ch <= h and 0 < cw <= w:
                i = rng().randint(0, h - ch + 1)
                j = rng().randint(0, w - cw + 1)
                patch = img[:, i:i + ch, j:j + cw]
                return functional.resize(patch, self.size,
                                         self.interpolation)
        return functional.resize(functional.center_crop(
            img, (min(h, w), min(h, w))), self.size, self.interpolation)
