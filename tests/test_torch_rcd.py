"""RCD demosaic of art_tpu_torch against `art_tpu.demosaic.rcd`, on the CPU.

Both are whole-plane stencil programs with the same float32 operations
in the same order, the same reflect pads and the same 9-pixel bilinear
ring; every division is an IEEE division on both sides (the one by
65536 is exact either way). Bound: 1e-2 of 65535 max, 1e-5 mean
(measured: equal) for all four Bayer patterns, at 64x96, at an odd
71x97 and at 256x1024.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.demosaic import registry as ref_registry
from art_tpu_torch.demosaic import demosaic
from art_tpu_torch.demosaic import rcd as trcd

# the reference's method registry fills itself only while it is empty;
# let it fill before importing one method module directly
ref_registry.get("rcd")
from art_tpu.demosaic import rcd as rrcd  # noqa: E402

PATTERNS = ["RGGB", "BGGR", "GRBG", "GBRG"]


def _mosaic(shape, seed):
    """A scene-like mosaic: smooth colour ramps, a hard edge, 2% noise,
    some clipped sites."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy = np.linspace(0, 1, h)[:, None]
    xx = np.linspace(0, 1, w)[None, :]
    base = 0.2 + 0.5 * xx * (0.5 + yy) + 0.25 * (xx > 0.6)
    cfa = base + rng.normal(0, 0.02, shape)
    return (np.clip(cfa, 0.0, 1.02) * 64000).astype(np.float32)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("shape", [(64, 96), (71, 97), (256, 1024)],
                         ids=["64x96", "odd", "256x1024"])
def test_rcd_matches_reference(shape, pattern):
    cfa = _mosaic(shape, 5)
    ref = np.asarray(rrcd.rcd_demosaic(jnp.asarray(cfa), pattern))
    out = demosaic(torch.from_numpy(cfa), pattern, "rcd").numpy()
    assert out.shape == ref.shape == (3, *shape)
    d = np.abs(out.astype(np.float64) - ref)
    assert d.max() <= 1e-2 and d.mean() <= 1e-5, (d.max(), d.mean())


def test_rcd_keeps_sampled_values_and_the_bilinear_ring():
    from art_tpu_torch.demosaic.bilinear import bayer_bilinear

    cfa = torch.from_numpy(_mosaic((64, 96), 6))
    out = trcd.rcd_demosaic(cfa, "RGGB")
    # R samples of the interior keep their value (x * 65536 / 65536)
    assert torch.equal(out[0, 10:-10:2, 10:-10:2], cfa[10:-10:2, 10:-10:2])
    ring = torch.ones(64, 96, dtype=torch.bool)
    ring[9:-9, 9:-9] = False
    assert torch.equal(out[:, ring], bayer_bilinear(cfa, "RGGB")[:, ring])
