"""The port's encoders against the reference's, on the CPU, with OpenCV
and PIL as oracles (here only: the port imports neither).

- The JPEG encoder writes the bytes of OpenCV's `imencode` (libjpeg's
  default compressor) for every quality, subsampling, size and content
  below: partial MCUs at the right and bottom edges (1x1, 7x13, 10x22,
  17x33, 257x430; 10 rows leave 4:2:0 chroma rows to repeat past the
  last averaged one), whole ones (64x96), flat, gradient and random
  blocks.
- `save_image` writes the reference's file byte for byte for a JPEG with
  an ICC profile (and XMP/IPTC) and no EXIF; with EXIF, the reference's
  `harvest` reads the same tags from both files' EXIF segments.
- TIFF 8/16/32 files equal the reference's bytes; PNG 8/16 files decode
  to the reference's pixels and carry its ICC profile.
"""

import itertools
import struct

import numpy as np
import pytest

from art_tpu.color.iccwrite import make_icc
from art_tpu.io import imagefile as ref_imagefile
from art_tpu.io.metadata import harvest
from art_tpu_torch.io import imagefile, jpeg
from art_tpu_torch.io.metadata import build_exif_bytes

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

SIZES = ((1, 1), (7, 13), (10, 22), (17, 33), (64, 96), (257, 430))
CONTENTS = ("random", "flat", "gradient")
JPEG_CASES = list(itertools.product((10, 50, 92, 100), (1, 2, 3), SIZES,
                                    CONTENTS))


def image(shape, content, seed=0):
    h, w = shape
    rng = np.random.default_rng(seed + h * 7 + w)
    if content == "random":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if content == "flat":
        return np.broadcast_to(rng.integers(0, 256, 3, dtype=np.uint8),
                               (h, w, 3)).copy()
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 255 // max(h + w - 2, 1)],
                    axis=-1).astype(np.uint8)


def cv2_jpeg(rgb, quality, subsampling):
    sampling = {1: cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                2: cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                3: cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}[subsampling]
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, quality,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("quality,subsampling,shape,content", JPEG_CASES)
def test_jpeg_equals_libjpeg(quality, subsampling, shape, content):
    rgb = image(shape, content)
    ours = jpeg.encode(rgb, quality=quality, subsampling=subsampling)
    assert ours == cv2_jpeg(rgb, quality, subsampling)


def test_jpeg_rejects_bad_input():
    with pytest.raises(ValueError):
        jpeg.encode(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        jpeg.encode(np.zeros((4, 4, 3), np.uint8), subsampling=4)


def segments(data):
    """(marker, payload) of each segment before the scan, and the rest."""
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        n = struct.unpack_from(">H", data, pos + 2)[0]
        out.append((data[pos + 1], data[pos + 4: pos + 2 + n]))
        pos += 2 + n
    return out, data[pos:]


@pytest.mark.parametrize("subsampling,meta", [(1, False), (2, False),
                                              (3, False), (3, True)])
def test_save_image_jpeg_equals_the_reference(tmp_path, subsampling, meta):
    rgb = image((257, 430), "random", seed=1)
    kw = dict(quality=92, icc_bytes=make_icc("sRGB"), subsampling=subsampling)
    if meta:
        kw.update(xmp_bytes=b"<x:xmpmeta>notes</x:xmpmeta>",
                  iptc_iim=b"\x1c\x02\x78\x00\x03abc")
    imagefile.save_image(tmp_path / "ours.jpg", rgb, **kw)
    ref_imagefile.save_image(str(tmp_path / "ref.jpg"), rgb, **kw)
    assert (tmp_path / "ours.jpg").read_bytes() == \
        (tmp_path / "ref.jpg").read_bytes()


def test_save_image_exif_reads_as_the_reference(tmp_path):
    from art_tpu.io.metadata import build_exif_bytes as ref_build_exif_bytes

    tags = {"make": "Maker", "model": "Cam 1", "iso": (400,),
            "orientation": 1, "datetime": "2024:05:06 07:08:09",
            "artist": "A. N. Other", "exposure_time": (1, 250),
            "f_number": (28, 10), "focal_length": (50, 1),
            "lens_model": "Lens 50", "datetime_original": "2024:05:06"}
    rgb = image((64, 96), "gradient")
    imagefile.save_image(tmp_path / "ours.jpg", rgb,
                         exif_bytes=build_exif_bytes(tags))
    ref_imagefile.save_image(str(tmp_path / "ref.jpg"), rgb,
                             exif_bytes=ref_build_exif_bytes(tags))
    read = []
    for name in ("ours", "ref"):
        segs, scan = segments((tmp_path / f"{name}.jpg").read_bytes())
        exif = [p for m, p in segs if m == 0xE1 and p[:6] == b"Exif\0\0"]
        assert [m for m, _ in segs][:2] == [0xE0, 0xE1]
        (tmp_path / f"{name}.tif").write_bytes(exif[0][6:])
        read.append((harvest(str(tmp_path / f"{name}.tif"))[0], scan))
    assert read[0] == read[1]
    assert read[0][0]["lens_model"] == "Lens 50"


@pytest.mark.parametrize("bits,uncompressed", [(8, False), (8, True),
                                               (16, False), (16, True),
                                               (32, False), (32, True)])
def test_tiff_equals_the_reference(tmp_path, bits, uncompressed):
    rgb = np.random.default_rng(bits).uniform(-0.1, 1.1, (3, 33, 47))
    rgb = rgb.astype(np.float32)
    kw = dict(bits=bits, uncompressed=uncompressed,
              icc_bytes=make_icc("Adobe RGB"),
              exif_tags={"make": "Maker", "model": "Cam 1", "iso": 100,
                         "exposure_time": (1, 60)},
              xmp_bytes=b"<x/>", iptc_iim=b"\x1c\x02\x05\x00\x01t")
    imagefile.save_image(tmp_path / "ours.tif", rgb, **kw)
    ref_imagefile.save_image(str(tmp_path / "ref.tif"), rgb, **kw)
    assert (tmp_path / "ours.tif").read_bytes() == \
        (tmp_path / "ref.tif").read_bytes()


def test_tiff_of_u8_equals_the_reference(tmp_path):
    rgb = image((17, 33), "random")
    imagefile.save_image(tmp_path / "ours.tif", rgb)
    ref_imagefile.save_image(str(tmp_path / "ref.tif"), rgb)
    assert (tmp_path / "ours.tif").read_bytes() == \
        (tmp_path / "ref.tif").read_bytes()


@pytest.mark.parametrize("bits", (8, 16))
def test_png_decodes_to_the_reference(tmp_path, bits):
    rgb = np.random.default_rng(5).uniform(-0.1, 1.1, (3, 31, 45))
    icc = make_icc("sRGB")
    kw = dict(bits=bits, icc_bytes=icc, xmp_bytes=b"<x:xmpmeta/>")
    imagefile.save_image(tmp_path / "ours.png", rgb, **kw)
    ref_imagefile.save_image(str(tmp_path / "ref.png"), rgb, **kw)
    if bits == 8:
        ours = Image.open(tmp_path / "ours.png")
        ref = Image.open(tmp_path / "ref.png")
        assert ours.mode == ref.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))
        assert ours.info["icc_profile"] == ref.info["icc_profile"] == icc
        assert ours.info["XML:com.adobe.xmp"] == \
            ref.info["XML:com.adobe.xmp"]
    else:
        ours = cv2.imread(str(tmp_path / "ours.png"), cv2.IMREAD_UNCHANGED)
        ref = cv2.imread(str(tmp_path / "ref.png"), cv2.IMREAD_UNCHANGED)
        assert ours.dtype == ref.dtype == np.uint16
        np.testing.assert_array_equal(ours, ref)
