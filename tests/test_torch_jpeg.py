"""The port's JPEG decoder (``tensorflow_examples_torch/data/csrc/jpeg.cpp``)
against PIL, ``native/fastjpeg.cpp`` and the reference's plain decode.

* The whole decode equals ``PIL.Image.open(...).convert("RGB")`` (PIL
  bundles libjpeg-turbo, whose integer decode the port repeats): on the
  64 images of ``tests/data/imagenet_fixture.tfrecord`` at full size and
  DCT-scaled by 1/2, 1/4 and 1/8 (PIL's ``draft``), and on JPEGs PIL
  writes from seeded numpy pixels: subsampling 4:4:4, 4:2:2 and 4:2:0,
  grey, progressive, restart markers, sizes that are not MCU multiples,
  quality 50 and 95, 4:4:0 and RGB-coded streams (component ids
  ``R``, ``G``, ``B`` or an Adobe APP14 transform 0). At most one level
  a channel may differ; the share of differing pixels is printed, and
  has been 0.
* The stage (decode, crop, resize, flip, normalize) against
  ``fastjpeg`` through the port's binding and against
  ``imagenet.decode_augment_reference``: within ``NORMALIZED_ATOL`` at
  224 px (the full-size decode) and within the reference's scaled-path
  bounds at 32 px (``tests/test_native.py``).
* ``jpeg_dims`` and the ``ok`` flags of garbage, truncated, edited and
  CMYK input equal ``fastjpeg``'s.
* The source includes no ``jpeglib.h``, the build line links no
  libjpeg, and the built library needs none.
* ``parallel_tfrecord_iter`` over shards of the fixture, decoding with
  the port's stage, equals the reference's stream (``fastjpeg``) batch
  for batch within ``NORMALIZED_ATOL``.
"""

import io
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
from PIL import Image

from tensorflow_examples_tpu import native as jax_native
from tensorflow_examples_tpu.data import imagenet as jax_imagenet
from tensorflow_examples_torch import native
from tensorflow_examples_torch.data import imagenet, sources

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "imagenet_fixture.tfrecord")
NORMALIZED_ATOL = 2.5 / 255.0 / 0.22  # the reference's fastjpeg tolerance


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """Record counts cached under the test's own directory."""
    monkeypatch.setenv("TFE_TPU_CACHE_DIR", str(tmp_path / "cache"))


def fixture_jpegs() -> list[bytes]:
    return [imagenet.parse_imagenet_example(r)[0]
            for r in sources.iter_tfrecord_records(FIXTURE, verify_crc=True)]


def pil_decode(data: bytes, denom: int = 1) -> np.ndarray:
    """PIL's decode to RGB, DCT-scaled by ``1/denom`` through ``draft``."""
    im = Image.open(io.BytesIO(data))
    if denom > 1:
        w, h = im.size
        im.draft(im.mode, (w // denom, h // denom))
        assert im.size == (-(-w // denom), -(-h // denom))
    return np.asarray(im.convert("RGB"))


def assert_decodes_as_pil(data: bytes, denoms=(1,), what: str = "") -> None:
    for denom in denoms:
        ours, theirs = native.decode_rgb(data, denom), pil_decode(data, denom)
        assert ours is not None, f"{what} 1/{denom}: the port's decoder failed"
        assert ours.shape == theirs.shape, what
        diff = np.abs(ours.astype(np.int16) - theirs.astype(np.int16))
        share = float((diff.max(-1) > 0).mean())
        print(f"{what} 1/{denom}: {share:.6f} of pixels differ, max {int(diff.max())}")
        assert diff.max() <= 1, f"{what} 1/{denom}: max diff {diff.max()}"


def seeded_pixels(h: int, w: int, seed: int, grey: bool = False) -> np.ndarray:
    """Smooth waves plus noise: edges for the IDCT, colour for chroma."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 60 * np.sin(xx / rng.uniform(3, 9) + c)
                    + 50 * np.cos(yy / rng.uniform(3, 9) - c) for c in range(3)], -1)
    img += rng.normal(0, 20, img.shape)
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def pil_jpeg(pixels: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "JPEG", **kw)
    return buf.getvalue()


def segments(data: bytes) -> list[tuple[int, int, int]]:
    """(marker, offset, end) of the marker segments before the first SOS."""
    out, i = [], 2
    while data[i + 1] != 0xDA:
        end = i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
        out.append((data[i + 1], i, end))
        i = end
    return out


def test_fixture_decodes_as_pil_at_every_scale():
    for i, jpeg in enumerate(fixture_jpegs()):
        assert_decodes_as_pil(jpeg, (1, 2, 4, 8), f"fixture {i}")


@pytest.mark.parametrize("h,w", [(1, 1), (17, 23), (9, 300), (64, 48)])
@pytest.mark.parametrize("kind", ["4:4:4", "4:2:2", "4:2:0", "grey", "progressive",
                                  "progressive grey", "restart", "progressive restart"])
@pytest.mark.parametrize("quality", [50, 95])
def test_pil_written_jpegs_decode_as_pil(h, w, kind, quality):
    grey = "grey" in kind
    pixels = seeded_pixels(h, w, seed=h * 1000 + w, grey=grey)
    kw = {"quality": quality}
    if kind.startswith("4:"):
        kw["subsampling"] = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}[kind]
    kw["progressive"] = "progressive" in kind
    if "restart" in kind:
        kw["restart_marker_blocks"] = 3
    data = pil_jpeg(pixels, **kw)
    if "restart" in kind:
        assert 0xDD in [m for m, _, _ in segments(data)]  # DRI
    denoms = [d for d in (1, 2, 4, 8) if d <= min(h, w)]
    assert_decodes_as_pil(data, denoms, f"{h}x{w} {kind} q{quality}")


def test_h1v2_and_rgb_coded_streams_decode_as_pil():
    # 4:4:0 (luma sampled 1x2): a 4:2:2 stream of a square image with its
    # luma factors swapped holds the same blocks in the same MCU order.
    data = bytearray(pil_jpeg(seeded_pixels(48, 48, 7), quality=90, subsampling=1))
    (_, sof, _), = [s for s in segments(bytes(data)) if s[0] == 0xC0]
    assert data[sof + 11] == 0x21
    data[sof + 11] = 0x12
    assert_decodes_as_pil(bytes(data), (1, 2, 4, 8), "4:4:0")
    # RGB-coded: a 4:4:4 stream without JFIF, its components named R, G, B
    # (no colour conversion) or announced by an Adobe APP14 transform 0.
    base = pil_jpeg(seeded_pixels(40, 56, 8), quality=90, subsampling=0)
    (_, app0, app0_end), = [s for s in segments(base) if s[0] == 0xE0]
    no_jfif = bytearray(base[:app0] + base[app0_end:])
    (_, sof, _), = [s for s in segments(bytes(no_jfif)) if s[0] == 0xC0]
    ids = sof + 10
    for k, cid in enumerate(b"RGB"):
        no_jfif[ids + 3 * k] = cid
    sos = bytes(no_jfif).index(b"\xff\xda")
    for k, cid in enumerate(b"RGB"):
        no_jfif[sos + 5 + 2 * k] = cid
    assert_decodes_as_pil(bytes(no_jfif), (1, 2), "component ids R,G,B")
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    stream = base[:app0] + adobe + base[app0_end:]
    assert_decodes_as_pil(stream, (1, 4), "Adobe transform 0")
    assert not np.array_equal(native.decode_rgb(stream), native.decode_rgb(base))


@pytest.mark.parametrize("train", [True, False])
def test_stage_is_within_tolerance_of_fastjpeg_and_the_reference(train):
    assert native.available("jpeg") and native.available("fastjpeg")
    jpegs = fixture_jpegs()
    seeds = imagenet._image_seeds(7, 1, len(jpegs))
    kw = dict(train=train, seeds=seeds, mean=imagenet.MEAN_RGB, std=imagenet.STDDEV_RGB)
    # 224 px: every crop of these images is under 448, the full-size decode.
    ours, ok = native.decode_augment_batch(jpegs, out_size=224, **kw)
    theirs, ok_fj = native.decode_augment_batch(jpegs, out_size=224, library="fastjpeg", **kw)
    assert ok.all() and ok_fj.all()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=NORMALIZED_ATOL)
    exact = sum(np.array_equal(a, b) for a, b in zip(ours, theirs))
    print(f"224 px: {exact} of {len(jpegs)} images equal fastjpeg's bit for bit, the largest "
          f"difference {float(np.abs(ours - theirs).max()):.6f}")
    for i in range(0, len(jpegs), 4):
        ref = imagenet.decode_augment_reference(jpegs[i], train=train, seed=int(seeds[i]),
                                                out_size=224)
        np.testing.assert_allclose(ours[i], ref, rtol=0, atol=NORMALIZED_ATOL,
                                   err_msg=f"image {i}")
    # 32 px: the DCT-scaled decode, a prefilter of the same image.
    small, ok = native.decode_augment_batch(jpegs[:8], out_size=32,
                                            **{**kw, "seeds": seeds[:8]})
    assert ok.all()
    for i, j in enumerate(jpegs[:8]):
        ref = imagenet.decode_augment_reference(j, train=train, seed=int(seeds[i]), out_size=32)
        assert float(np.abs(small[i] - ref).mean()) < 0.08
        np.testing.assert_allclose(small[i], ref, rtol=0, atol=0.5)
    fj_small, _ = native.decode_augment_batch(jpegs[:8], out_size=32, library="fastjpeg",
                                              **{**kw, "seeds": seeds[:8]})
    np.testing.assert_allclose(small, fj_small, rtol=0, atol=NORMALIZED_ATOL)


def broken_inputs() -> dict:
    rng = np.random.default_rng(3)
    pixels = seeded_pixels(40, 56, 9)
    cmyk = io.BytesIO()
    Image.fromarray(pixels).convert("CMYK").save(cmyk, "JPEG")
    out = {"garbage": b"not a jpeg", "empty": b"", "soi only": b"\xff\xd8",
           "cmyk": cmyk.getvalue(),
           "soi + noise": b"\xff\xd8" + rng.integers(0, 256, 500, np.uint8).tobytes()}
    streams = {"baseline": fixture_jpegs()[0],
               "progressive": pil_jpeg(pixels, quality=80, progressive=True),
               "restart": pil_jpeg(pixels, quality=80, restart_marker_blocks=2)}
    for name, s in streams.items():
        for cut in np.linspace(2, len(s) - 1, 24).astype(int):
            out[f"{name} cut at {cut}"] = s[:cut]
        for k in range(24):
            b = bytearray(s)
            b[int(rng.integers(2, len(b)))] = int(rng.integers(0, 256))
            out[f"{name} edit {k}"] = bytes(b)
    return out


def test_dims_and_ok_flags_equal_fastjpeg():
    for jpeg in fixture_jpegs()[:8]:
        assert native.jpeg_dims(jpeg) == native.jpeg_dims(jpeg, library="fastjpeg")
    cases = broken_inputs()
    names, data = list(cases), list(cases.values())
    for train, size in ((True, 32), (False, 224)):
        kw = dict(train=train, out_size=size, seeds=np.arange(len(data), dtype=np.uint64),
                  mean=imagenet.MEAN_RGB, std=imagenet.STDDEV_RGB)
        _, ok = native.decode_augment_batch(data, **kw)
        _, ok_fj = native.decode_augment_batch(data, library="fastjpeg", **kw)
        assert [names[i] for i in np.flatnonzero(ok != ok_fj)] == []
        assert ok[:5].tolist() == [0, 0, 0, 0, 0] and 0 < ok.sum() < len(ok)
    for name, d in cases.items():
        assert native.jpeg_dims(d) == native.jpeg_dims(d, library="fastjpeg"), name


def test_source_and_build_do_not_use_libjpeg():
    src = open(native.JPEG_SOURCE).read()
    assert not re.search(r"#\s*include\s*[<\"]jpeglib\.h", src)
    assert not any("jpeg" in flag for flag in native.JPEG_CXXFLAGS)
    assert native.available("jpeg")
    path = native.jpeg_library_path()
    assert os.path.exists(path)
    if shutil.which("ldd"):
        needed = subprocess.run(["ldd", path], capture_output=True, text=True).stdout
        assert "libjpeg" not in needed, needed


def write_shards(root, n_train: int = 24, n_val: int = 6) -> str:
    jpegs = fixture_jpegs()
    os.makedirs(root, exist_ok=True)
    for name, lo, n in (("train-00000-of-00002", 0, n_train // 2),
                        ("train-00001-of-00002", n_train // 2, n_train // 2),
                        ("validation-00000-of-00001", n_train, n_val)):
        recs = [sources.make_example({"image/encoded": jpegs[(lo + i) % len(jpegs)],
                                      "image/class/label": 1 + (lo + i) % 5})
                for i in range(n)]
        sources.write_tfrecord(os.path.join(root, name), recs)
    return str(root)


@pytest.mark.parametrize("split", ["train", "validation"])
def test_tfrecord_stream_is_within_tolerance_of_the_reference(tmp_path, split):
    root = write_shards(tmp_path / "data")
    train = split == "train"
    kw = dict(train=train, image_size=112, num_readers=2, host_index=0, host_count=1)
    if train:
        kw.update(seed=4, shuffle_window=8)
    ours = imagenet.parallel_tfrecord_iter(root, split, 4, num_workers=2, **kw)
    theirs = jax_imagenet.parallel_tfrecord_iter(root, split, 4, num_workers=0, **kw)
    n = 5 if train else 2
    got = [next(ours) for _ in range(n)]
    want = [next(theirs) for _ in range(n)]
    ours.close()
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            if k == "image":
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=NORMALIZED_ATOL)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert native.available("jpeg") and jax_native.available("fastjpeg")
