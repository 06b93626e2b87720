"""Host image augmentation, numpy over the whole batch: the port of
``tensorflow_examples_tpu/data/augment.py``.

Everything is driven by the train iterator's per-step
``np.random.Generator`` (``data/memory.train_iterator``), so a batch's
augmentation is a pure function of (seed, step) and replays exactly on
resume. The rng draws come in the reference's order (crop rows, crop
columns, flips) on every path, so each path's output equals the
reference's bit for bit.
"""

from __future__ import annotations

import numpy as np

from tensorflow_examples_torch import native
from tensorflow_examples_torch.data.sources import CIFAR10_MEAN, CIFAR10_STD

# (mean bytes, std bytes) -> the [256, C] f32 table of normalize_lut.
_NORM_LUT_CACHE: dict = {}


def normalize_lut(mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """The 256-entry per-channel table for uint8 images: entry [v, c] is
    ``(v / 255 - mean[c]) / std[c]`` in f32, the direct expression's
    value, so a gather through it is byte-identical to the formula."""
    key = (mean.astype(np.float32).tobytes(), std.astype(np.float32).tobytes())
    lut = _NORM_LUT_CACHE.get(key)
    if lut is None:
        vals = np.arange(256, dtype=np.float32)[:, None] / 255.0
        lut = (vals - mean.astype(np.float32)) / std.astype(np.float32)
        lut = _NORM_LUT_CACHE[key] = np.ascontiguousarray(lut.astype(np.float32))
    return lut


def normalize_images(images: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """``(x / 255 - mean) / std`` of a batch: uint8 through the table,
    float by the direct expression."""
    if images.dtype == np.uint8:
        lut = normalize_lut(mean, std)
        return np.ascontiguousarray(lut[images, np.arange(images.shape[-1], dtype=np.intp)])
    return ((images.astype(np.float32) / 255.0 - mean.astype(np.float32))
            / std.astype(np.float32)).astype(np.float32)


def flip_images(images: np.ndarray, flips: np.ndarray, *, copy: bool = True) -> np.ndarray:
    """Flip the rows of a batch where ``flips`` is set, horizontally, in
    one vectorized assignment."""
    out = images.copy() if copy else images
    fl = flips.astype(bool)
    out[fl] = out[fl, :, ::-1]
    return np.ascontiguousarray(out)


def _crop_flip(images: np.ndarray, ys: np.ndarray, xs: np.ndarray, flips: np.ndarray,
               pad: int) -> np.ndarray:
    """Reflect-pad, crop each image at its offsets and flip: one gather
    for the batch, shared by the float path and the uint8 fallback."""
    b, h, w, _ = images.shape
    padded = np.pad(images, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="reflect")
    row_idx = ys[:, None] + np.arange(h)[None, :]
    col_idx = xs[:, None] + np.arange(w)[None, :]
    out = padded[np.arange(b)[:, None, None], row_idx[:, :, None], col_idx[:, None, :]]
    return flip_images(out, flips, copy=False)


def random_crop_flip(images: np.ndarray, rng: np.random.Generator, *, pad: int = 4) -> np.ndarray:
    """CIFAR's augmentation: reflect-pad by ``pad``, a random crop and a
    random horizontal flip."""
    b = len(images)
    ys = rng.integers(0, 2 * pad + 1, size=b)
    xs = rng.integers(0, 2 * pad + 1, size=b)
    flips = rng.random(b) < 0.5
    return _crop_flip(images, ys, xs, flips, pad)


def cifar_augment(batch: dict, rng: np.random.Generator) -> dict:
    """Crop and flip a CIFAR batch. f32 images (synthetic, or loaded
    normalized) take the numpy path; uint8 images
    (``load_cifar10(normalized=False)``) are padded, cropped, flipped and
    normalized in one threaded C++ call (``native.crop_flip_normalize``),
    or by numpy without the library."""
    out = dict(batch)
    img = batch["image"]
    if img.dtype != np.uint8:
        out["image"] = random_crop_flip(img, rng, pad=4)
        return out
    b, pad = len(img), 4
    ys = rng.integers(0, 2 * pad + 1, size=b)
    xs = rng.integers(0, 2 * pad + 1, size=b)
    flips = (rng.random(b) < 0.5).astype(np.uint8)
    fast = native.crop_flip_normalize(img, ys, xs, flips, CIFAR10_MEAN, CIFAR10_STD, pad=pad)
    if fast is not None:
        out["image"] = fast
        return out
    crop = _crop_flip(img.astype(np.float32) / 255.0, ys, xs, flips, pad=pad)
    out["image"] = ((crop - CIFAR10_MEAN) / CIFAR10_STD).astype(np.float32)
    return out
