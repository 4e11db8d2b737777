"""``paddle.vision.transforms`` of the port (counterpart of
``paddle_tpu/vision/transforms.py``): host-side transforms of HWC numpy
images (no PIL). The random ones draw from Python's ``random`` module,
as the reference's do. ``to_tensor`` / ``ToTensor`` give a float32 CHW
``torch.Tensor`` (uint8 scaled to [0, 1]); ``normalize`` takes an array
or a tensor and returns the same kind."""
from __future__ import annotations

import numbers
import random

import numpy as np
import torch

__all__ = ["Compose", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
           "Transpose", "BrightnessTransform", "Pad", "RandomResizedCrop",
           "to_tensor", "normalize", "resize", "hflip", "vflip"]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


def _as_hwc(img):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def to_tensor(img, data_format="CHW"):
    img = _as_hwc(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32)
    if data_format == "CHW":
        img = np.transpose(img, (2, 0, 1))
    return torch.from_numpy(np.ascontiguousarray(img))


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        return to_tensor(img, self.data_format)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    is_tensor = isinstance(img, torch.Tensor)
    arr = img.numpy() if is_tensor else np.asarray(img, np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        arr = (arr - mean.reshape(-1, 1, 1)) / std.reshape(-1, 1, 1)
    else:
        arr = (arr - mean) / std
    return torch.from_numpy(np.ascontiguousarray(arr)) if is_tensor \
        else arr


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean = mean
        self.std = std
        self.data_format = data_format

    def _apply_image(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


def resize(img, size, interpolation="bilinear"):
    img = _as_hwc(img)
    h, w = img.shape[:2]
    if isinstance(size, int):
        if h < w:
            oh, ow = size, int(size * w / h)
        else:
            oh, ow = int(size * h / w), size
    else:
        oh, ow = size
    # nearest/bilinear resize in numpy
    ys = np.linspace(0, h - 1, oh)
    xs = np.linspace(0, w - 1, ow)
    if interpolation == "nearest":
        out = img[np.round(ys).astype(int)[:, None],
                  np.round(xs).astype(int)[None, :]]
    else:
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = (ys - y0)[:, None, None]
        wx = (xs - x0)[None, :, None]
        img_f = img.astype(np.float32)
        out = (img_f[y0[:, None], x0[None, :]] * (1 - wy) * (1 - wx)
               + img_f[y1[:, None], x0[None, :]] * wy * (1 - wx)
               + img_f[y0[:, None], x1[None, :]] * (1 - wy) * wx
               + img_f[y1[:, None], x1[None, :]] * wy * wx)
        out = out.astype(img.dtype)
    return out


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return resize(img, self.size, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else size

    def _apply_image(self, img):
        img = _as_hwc(img)
        h, w = img.shape[:2]
        th, tw = self.size
        i = max(0, (h - th) // 2)
        j = max(0, (w - tw) // 2)
        return img[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else size
        self.padding = padding

    def _apply_image(self, img):
        img = _as_hwc(img)
        if self.padding:
            p = self.padding if isinstance(self.padding, (list, tuple)) \
                else [self.padding] * 4
            img = np.pad(img, ((p[1], p[3]), (p[0], p[2]), (0, 0)))
        h, w = img.shape[:2]
        th, tw = self.size
        i = random.randint(0, max(0, h - th))
        j = random.randint(0, max(0, w - tw))
        return img[i:i + th, j:j + tw]


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        img = _as_hwc(img)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * random.uniform(*self.scale)
            ar = np.exp(random.uniform(np.log(self.ratio[0]),
                                       np.log(self.ratio[1])))
            tw = int(round(np.sqrt(target_area * ar)))
            th = int(round(np.sqrt(target_area / ar)))
            if 0 < tw <= w and 0 < th <= h:
                i = random.randint(0, h - th)
                j = random.randint(0, w - tw)
                return resize(img[i:i + th, j:j + tw], self.size,
                              self.interpolation)
        return resize(img, self.size, self.interpolation)


def hflip(img):
    return _as_hwc(img)[:, ::-1]


def vflip(img):
    return _as_hwc(img)[::-1]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return hflip(img)
        return _as_hwc(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return vflip(img)
        return _as_hwc(img)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        img = _as_hwc(img)
        return np.transpose(img, self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        img = _as_hwc(img).astype(np.float32)
        factor = 1 + random.uniform(-self.value, self.value)
        return np.clip(img * factor, 0, 255).astype(np.uint8)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        p = padding if isinstance(padding, (list, tuple)) \
            else [padding] * 4
        if len(p) == 2:
            p = [p[0], p[1], p[0], p[1]]
        self.padding = p
        self.fill = fill

    def _apply_image(self, img):
        img = _as_hwc(img)
        p = self.padding
        return np.pad(img, ((p[1], p[3]), (p[0], p[2]), (0, 0)),
                      constant_values=self.fill)
