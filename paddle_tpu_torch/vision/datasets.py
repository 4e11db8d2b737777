"""``paddle.vision.datasets`` of the port (counterpart of
``paddle_tpu/vision/datasets.py``): MNIST, FashionMNIST, Cifar10 / 100,
Flowers and ImageFolder.

Nothing is downloaded. The IDX (gzip) and pickle files are read where
they are on disk (``~/.cache/paddle/dataset``, Paddle's download cache
layout); otherwise each dataset is the reference's seeded synthetic
sample of the real shapes and label space (:func:`_synthetic_images`:
MNIST seeds 42 / 43, FashionMNIST 52 / 53, Cifar 62 / 63, Flowers 72 /
73 for train / test; class patterns from one split-independent seed), so
both packages see the same images. A sample is ``(image, int64 label)``:
float32 ``[C, H, W]`` in [0, 1] unless a ``transform`` is given.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from ..io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers",
           "ImageFolder"]

CACHE_DIR = os.path.expanduser("~/.cache/paddle/dataset")


def _synthetic_images(n, shape, num_classes, seed):
    """``n`` uint8 images and int64 labels: each class a fixed pattern
    (one seed for every split) plus per-sample noise, so a model trained
    on the train split generalises to the test split."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n).astype(np.int64)
    imgs = np.zeros((n,) + shape, np.uint8)
    pattern_rng = np.random.RandomState(1234)  # split-independent
    for c in range(num_classes):
        base = pattern_rng.randint(0, 255, size=shape).astype(np.float32)
        mask = labels == c
        k = int(mask.sum())
        if not k:
            continue
        noise = rng.randint(0, 60, size=(k,) + shape)
        imgs[mask] = np.clip(base[None] * 0.7 + noise, 0, 255)
    return imgs, labels


class MNIST(Dataset):
    NUM_CLASSES = 10
    IMAGE_SHAPE = (28, 28)

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend="numpy"):
        self.mode = mode
        self.transform = transform
        self.backend = backend
        images, labels = self._load(image_path, label_path, mode)
        self.images = images
        self.labels = labels

    def _load(self, image_path, label_path, mode):
        name = "train" if mode == "train" else "t10k"
        image_path = image_path or os.path.join(
            CACHE_DIR, "mnist", f"{name}-images-idx3-ubyte.gz")
        label_path = label_path or os.path.join(
            CACHE_DIR, "mnist", f"{name}-labels-idx1-ubyte.gz")
        if os.path.exists(image_path) and os.path.exists(label_path):
            with gzip.open(image_path, "rb") as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                images = np.frombuffer(f.read(), np.uint8).reshape(
                    n, rows, cols)
            with gzip.open(label_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)
            return images, labels
        n = 8192 if mode == "train" else 1024
        return _synthetic_images(n, self.IMAGE_SHAPE, self.NUM_CLASSES,
                                 seed=42 if mode == "train" else 43)

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32)[None] / 255.0
        return img, np.asarray(label, np.int64)

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    def _load(self, image_path, label_path, mode):
        name = "train" if mode == "train" else "t10k"
        image_path = image_path or os.path.join(
            CACHE_DIR, "fashion-mnist", f"{name}-images-idx3-ubyte.gz")
        label_path = label_path or os.path.join(
            CACHE_DIR, "fashion-mnist", f"{name}-labels-idx1-ubyte.gz")
        if os.path.exists(image_path) and os.path.exists(label_path):
            return super()._load(image_path, label_path, mode)
        n = 8192 if mode == "train" else 1024
        return _synthetic_images(n, self.IMAGE_SHAPE, self.NUM_CLASSES,
                                 seed=52 if mode == "train" else 53)


class Cifar10(Dataset):
    NUM_CLASSES = 10
    IMAGE_SHAPE = (32, 32, 3)

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="numpy"):
        self.mode = mode
        self.transform = transform
        data_file = data_file or os.path.join(CACHE_DIR, "cifar",
                                              "cifar-10-python.tar.gz")
        if os.path.exists(data_file):
            self.images, self.labels = self._load_tar(data_file, mode)
        else:
            n = 8192 if mode == "train" else 1024
            self.images, self.labels = _synthetic_images(
                n, self.IMAGE_SHAPE, self.NUM_CLASSES,
                seed=62 if mode == "train" else 63)

    def _load_tar(self, path, mode):
        import tarfile
        images, labels = [], []
        want = "data_batch" if mode == "train" else "test_batch"
        with tarfile.open(path) as tf:
            for member in tf.getmembers():
                if want in member.name:
                    d = pickle.load(tf.extractfile(member),
                                    encoding="bytes")
                    images.append(d[b"data"].reshape(-1, 3, 32, 32)
                                  .transpose(0, 2, 3, 1))
                    labels.extend(d[b"labels"])
        return (np.concatenate(images),
                np.asarray(labels, np.int64))

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32).transpose(2, 0, 1) / 255.0
        return img, np.asarray(label, np.int64)

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NUM_CLASSES = 100


class Flowers(Dataset):
    NUM_CLASSES = 102
    IMAGE_SHAPE = (224, 224, 3)

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True,
                 backend="numpy"):
        self.transform = transform
        n = 2048 if mode == "train" else 512
        self.images, self.labels = _synthetic_images(
            n, self.IMAGE_SHAPE, self.NUM_CLASSES,
            seed=72 if mode == "train" else 73)

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32).transpose(2, 0, 1) / 255.0
        return img, np.asarray(label, np.int64)

    def __len__(self):
        return len(self.images)


class ImageFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.samples = []
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d))) \
            if os.path.isdir(root) else []
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        exts = extensions or (".npy",)
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(exts):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = np.load(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(label, np.int64)

    def __len__(self):
        return len(self.samples)
