"""ctypes bindings for the repo's host augmentation library
(``native/fastdata.cpp``): a jax-free copy of the ``fastdata`` half of
``tensorflow_examples_tpu/native/__init__.py``.

``crop_flip_normalize`` and ``normalize`` run threaded C++ over a uint8
NHWC batch on the host (input-pipeline work, not a device kernel). The
library is built on first use from the repo's own ``native/Makefile``
into the git-ignored ``native/build/``: ``make`` writes into a private
directory and the result is renamed into place, so processes that build
at once do not see a half-written file; a copy that does not load (built
on another machine) is rebuilt once. Without a toolchain both
functions return None and the callers (``data/augment.py``) take their
numpy path, whose output is bit-identical.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
import shutil
import subprocess
import tempfile

import numpy as np

log = logging.getLogger(__name__)

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")


def _build(name: str, path: str) -> bool:
    """``make`` the library into a private directory, then rename it to
    ``path``; False (and a warning) without a toolchain."""
    if not os.path.isfile(os.path.join(NATIVE_DIR, "Makefile")):
        return False
    os.makedirs(os.path.dirname(path), exist_ok=True)
    private = tempfile.mkdtemp(prefix=".make-", dir=os.path.dirname(path))
    try:
        rel = os.path.relpath(private, NATIVE_DIR)
        subprocess.run(["make", "-C", NATIVE_DIR, f"BUILD={rel}", f"{rel}/lib{name}.so"],
                       check=True, capture_output=True, timeout=120)
        os.replace(os.path.join(private, f"lib{name}.so"), path)
        return True
    except Exception as e:  # no toolchain: the numpy path
        log.warning("native build of %s failed: %s", name, e)
        return False
    finally:
        shutil.rmtree(private, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def _load(name: str):
    """The library, built on first use; a copy that does not load here
    (built on another machine) is rebuilt once."""
    path = os.path.join(NATIVE_DIR, "build", f"lib{name}.so")
    for attempt in range(2):
        if not os.path.exists(path) or attempt:
            if not _build(name, path):
                return None
        try:
            return ctypes.CDLL(path)
        except OSError as e:
            log.warning("failed to load %s: %s", path, e)
    return None


def available(name: str = "fastdata") -> bool:
    return _load(name) is not None


_U8 = ctypes.POINTER(ctypes.c_uint8)
_F32 = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)


def _stats(mean: np.ndarray, std: np.ndarray):
    return (np.ascontiguousarray(mean.astype(np.float32)),
            np.ascontiguousarray(1.0 / std.astype(np.float32)))


def crop_flip_normalize(images_u8: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                        flips: np.ndarray, mean: np.ndarray, std: np.ndarray, *,
                        pad: int = 4, out_size: tuple[int, int] | None = None,
                        threads: int | None = None) -> np.ndarray | None:
    """Reflect-pad, crop at (``ys``, ``xs``) in padded coordinates, flip
    where ``flips`` and normalize a [B, H, W, C] uint8 batch: [B, h, w, C]
    f32, or None without the library."""
    lib = _load("fastdata")
    if lib is None:
        return None
    b, h, w, c = images_u8.shape
    oh, ow = out_size or (h, w)
    out = np.empty((b, oh, ow, c), np.float32)
    images_u8 = np.ascontiguousarray(images_u8)
    mean, inv_std = _stats(mean, std)
    ys = np.ascontiguousarray(ys.astype(np.int32))
    xs = np.ascontiguousarray(xs.astype(np.int32))
    flips = np.ascontiguousarray(flips.astype(np.uint8))
    nthreads = threads or min(16, os.cpu_count() or 1)
    lib.crop_flip_normalize_u8(
        images_u8.ctypes.data_as(_U8), out.ctypes.data_as(_F32), ys.ctypes.data_as(_I32),
        xs.ctypes.data_as(_I32), flips.ctypes.data_as(_U8), mean.ctypes.data_as(_F32),
        inv_std.ctypes.data_as(_F32),
        *map(ctypes.c_int64, (b, h, w, oh, ow, c, pad, nthreads)))
    return out


def normalize(images_u8: np.ndarray, mean: np.ndarray, std: np.ndarray, *,
              threads: int | None = None) -> np.ndarray | None:
    """``(x / 255 - mean) / std`` of a uint8 NHWC batch in f32, or None
    without the library."""
    lib = _load("fastdata")
    if lib is None:
        return None
    b, h, w, c = images_u8.shape
    out = np.empty((b, h, w, c), np.float32)
    images_u8 = np.ascontiguousarray(images_u8)
    mean, inv_std = _stats(mean, std)
    nthreads = threads or min(16, os.cpu_count() or 1)
    lib.normalize_u8(images_u8.ctypes.data_as(_U8), out.ctypes.data_as(_F32),
                     mean.ctypes.data_as(_F32), inv_std.ctypes.data_as(_F32),
                     *map(ctypes.c_int64, (b, h * w, c, nthreads)))
    return out
