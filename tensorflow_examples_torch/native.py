"""ctypes bindings for the port's host input libraries.

* ``data/csrc/jpeg.cpp``, the port's own JPEG stage: a JPEG decoder that
  repeats libjpeg-turbo's integer decode (no libjpeg), then the ResNet
  crop, bilinear resize, flip and normalize, in one threaded C++ call
  (``decode_augment_batch``; ``jpeg_dims`` reads a header,
  ``decode_rgb`` returns a whole decoded image). It is built on first
  use with ``g++`` into ``build/torch_host/`` at the checkout root
  (``build/`` is git-ignored), named by a hash of the source and the
  flags: ``g++`` writes into a private directory and the result is
  renamed into place, so processes and decode workers that build at
  once never load a half-written file.
* ``native/fastdata.cpp`` (``crop_flip_normalize``, ``normalize``) and
  ``native/fastjpeg.cpp`` through a jax-free copy of the ``fastdata`` and
  ``fastjpeg`` parts of ``tensorflow_examples_tpu/native/__init__.py``,
  built from the repo's own ``native/Makefile`` into the git-ignored
  ``native/build/`` the same way; a copy that does not load (built on
  another machine) is rebuilt once. ``fastjpeg`` links libjpeg and is
  only the tests' oracle for the port's stage (``library="fastjpeg"``).

This is input-pipeline work on the host, not a device kernel. Without
a toolchain the functions return None: ``data/augment.py`` then takes
its numpy path, whose output is bit-identical, and ``data/imagenet.py``
its PIL decode, on a machine without CUDA only.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile

import numpy as np

log = logging.getLogger(__name__)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(ROOT, "native")
JPEG_SOURCE = os.path.join(ROOT, "tensorflow_examples_torch", "data", "csrc", "jpeg.cpp")
HOST_BUILD_DIR = os.path.join(ROOT, "build", "torch_host")
JPEG_CXXFLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# name -> why the library did not build or load, for the callers' errors.
build_errors: dict[str, str] = {}


def jpeg_library_path() -> str:
    """``build/torch_host/libjpeg-<hash>.so``: a hash of the source and
    the flags, so an edited source rebuilds."""
    with open(JPEG_SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(JPEG_CXXFLAGS).encode()).hexdigest()
    return os.path.join(HOST_BUILD_DIR, f"libjpeg-{digest[:16]}.so")


def _build_jpeg(path: str) -> bool:
    """``g++`` the port's JPEG stage into a private directory, then rename
    it to ``path``; False (and a warning) without a compiler."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    private = tempfile.mkdtemp(prefix=".build-", dir=os.path.dirname(path))
    try:
        out = os.path.join(private, os.path.basename(path))
        cxx = shutil.which("g++") or "g++"
        p = subprocess.run([cxx, *JPEG_CXXFLAGS, "-o", out, JPEG_SOURCE], capture_output=True,
                           text=True, timeout=300)
        if p.returncode:
            raise RuntimeError(f"g++ exit {p.returncode}: {p.stderr[-2000:]}")
        os.replace(out, path)
        return True
    except Exception as e:  # no compiler: the caller decides
        build_errors["jpeg"] = f"build of {JPEG_SOURCE} failed: {e}"
        log.warning("%s", build_errors["jpeg"])
        return False
    finally:
        shutil.rmtree(private, ignore_errors=True)


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
    """The library (``"jpeg"``, the port's stage, or ``native/``'s
    ``"fastdata"``/``"fastjpeg"``), built on first use; a copy that does
    not load here (built on another machine) is rebuilt once."""
    if name == "jpeg":
        path, build = jpeg_library_path(), _build_jpeg
    else:
        path = os.path.join(NATIVE_DIR, "build", f"lib{name}.so")
        build = functools.partial(_build, name)
    for attempt in range(2):
        if not os.path.exists(path) or attempt:
            if not build(path):
                return None
        try:
            return ctypes.CDLL(path)
        except OSError as e:
            build_errors[name] = f"failed to load {path}: {e}"
            log.warning("%s", build_errors[name])
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


_I64 = ctypes.POINTER(ctypes.c_int64)
_U64 = ctypes.POINTER(ctypes.c_uint64)


def decode_augment_batch(jpegs: "list[bytes]", *, train: bool, out_size: int,
                         seeds: np.ndarray | None, mean: np.ndarray, std: np.ndarray,
                         threads: int | None = None,
                         library: str = "jpeg") -> "tuple[np.ndarray, np.ndarray] | None":
    """JPEG decode (DCT-scaled) + ResNet random-resized crop (train) or
    central 87.5% crop (eval) + bilinear resize + flip + normalize, one
    threaded C++ call of ``library`` (the port's ``"jpeg"``, or
    ``"fastjpeg"``, the tests' oracle). ``seeds``: [n] uint64, one
    splitmix64 stream an image (unused in eval). Returns ``(images f32
    [n, S, S, 3], ok uint8 [n])``, a failed decode zero-filled with ok 0;
    None without the library."""
    lib = _load(library)
    if lib is None:
        return None
    n = len(jpegs)
    data = np.frombuffer(b"".join(jpegs), np.uint8)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(j) for j in jpegs], out=offsets[1:])
    seeds = np.zeros(n, np.uint64) if seeds is None else seeds
    seeds = np.ascontiguousarray(seeds.astype(np.uint64))
    out = np.empty((n, out_size, out_size, 3), np.float32)
    ok = np.empty(n, np.uint8)
    mean, inv_std = _stats(mean, std)
    nthreads = threads or min(16, os.cpu_count() or 1)
    lib.fj_decode_augment_batch.restype = ctypes.c_int64
    lib.fj_decode_augment_batch(
        data.ctypes.data_as(_U8), offsets.ctypes.data_as(_I64), ctypes.c_int64(n),
        ctypes.c_int32(1 if train else 0), ctypes.c_int32(out_size), seeds.ctypes.data_as(_U64),
        mean.ctypes.data_as(_F32), inv_std.ctypes.data_as(_F32), out.ctypes.data_as(_F32),
        ctypes.c_int64(nthreads), ok.ctypes.data_as(_U8))
    return out, ok


def jpeg_dims(data: bytes, library: str = "jpeg") -> "tuple[int, int] | None":
    """(height, width) from a JPEG's header; None on a bad header or
    without the library."""
    lib = _load(library)
    if lib is None:
        return None
    arr = np.frombuffer(data, np.uint8)
    h, w = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.fj_jpeg_dims(arr.ctypes.data_as(_U8), ctypes.c_int64(len(data)), ctypes.byref(h),
                          ctypes.byref(w))
    return None if rc else (h.value, w.value)


def decode_rgb(data: bytes, denom: int = 1) -> "np.ndarray | None":
    """The whole image through the port's decoder, DCT-scaled by
    ``1/denom`` (1, 2, 4 or 8): uint8 [ceil(h/denom), ceil(w/denom), 3];
    None where it does not decode or without the library."""
    lib = _load("jpeg")
    dims = jpeg_dims(data)
    if lib is None or dims is None:
        return None
    h, w = (-(-n // denom) for n in dims)
    out = np.empty((h, w, 3), np.uint8)
    arr = np.frombuffer(data, np.uint8)
    oh, ow = ctypes.c_int32(), ctypes.c_int32()
    lib.pj_decode_rgb.argtypes = [_U8, ctypes.c_int64, ctypes.c_int32, _U8, ctypes.c_int64,
                                  _I32, _I32]
    lib.pj_decode_rgb.restype = ctypes.c_int32
    rc = lib.pj_decode_rgb(arr.ctypes.data_as(_U8), ctypes.c_int64(len(data)),
                           ctypes.c_int32(denom), out.ctypes.data_as(_U8),
                           ctypes.c_int64(out.nbytes), ctypes.byref(oh), ctypes.byref(ow))
    return None if rc else out
