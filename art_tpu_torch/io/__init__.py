"""Host I/O (counterpart of :mod:`art_tpu.io`): raw decode, image encode
and metadata, with no PIL or OpenCV."""

from art_tpu_torch.io.rawfile import RawFrame, load_raw  # noqa: F401


def load_image(path):
    """Load a raw file as a RawFrame (``art_tpu/io/__init__.py::
    load_image``, raw only): a non-raw image raises, since the
    reference's ``io/imagefile.py::load_std_image`` is not ported."""
    from art_tpu_torch.io import rawfile

    if rawfile.is_raw_file(path):
        return rawfile.load_raw(path)
    raise NotImplementedError(
        f"non-raw input {str(path)!r}: io/imagefile.py::load_std_image is "
        "not ported to art_tpu_torch")
