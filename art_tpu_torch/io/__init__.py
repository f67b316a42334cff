"""Host I/O (counterpart of :mod:`art_tpu.io`): raw decode, image encode
and metadata, with no PIL or OpenCV."""

from art_tpu_torch.io.rawfile import RawFrame, load_raw  # noqa: F401


def load_image(path):
    """Load any supported file into an image source (raw or not), as
    ``art_tpu/io/__init__.py::load_image`` does (InitialImage::load,
    loadinitial.cc:24-46): a raw file by its extension through
    `rawfile.load_raw`, anything else through
    `imagefile.load_std_image`."""
    from art_tpu_torch.io import imagefile, rawfile

    if rawfile.is_raw_file(path):
        return rawfile.load_raw(path)
    return imagefile.load_std_image(path)
