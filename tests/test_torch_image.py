"""Parity of the port's mask ops (`rt3d_torch.geometry.image`) with the JAX
package: erosion and dilation bit for bit, the random subsample by its
semantics (its random bits come from a `torch.Generator`, not a JAX key,
so they cannot match)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rt3d.geometry import image as jimage
from rt3d_torch.geometry import image
from rt3d_torch.geometry.ops import PointBuffer


def _masks(rng, shape=(2, 3, 40, 56)):
    """Random blobs and speckle, with set pixels on every border."""
    m = rng.uniform(size=shape) < 0.7
    h, w = shape[-2:]
    yy, xx = np.mgrid[:h, :w]
    blob = (yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (h / 3) ** 2
    m[..., 0, :] = m[..., -1, :] = True
    m[..., :, 0] = m[..., :, -1] = True
    m[0, 0] = blob
    m[0, 1] = True
    m[1, 2] = False
    return m


@pytest.mark.parametrize("k", [3, 10, 12])
def test_erode_and_dilate_match_jax(rng, k):
    """Bit for bit, even and odd windows; an all-set mask keeps its border
    (cv2's default border value) and an empty one stays empty."""
    m = _masks(rng)
    er = image.erode_mask(torch.from_numpy(m), k).numpy()
    di = image.dilate_mask(torch.from_numpy(m), k).numpy()
    np.testing.assert_array_equal(er, np.asarray(jimage.erode_mask(jnp.asarray(m), k)))
    np.testing.assert_array_equal(di, np.asarray(jimage.dilate_mask(jnp.asarray(m), k)))
    assert er[0, 1].all() and not er[1, 2].any() and not di[1, 2].any()
    assert 0 < er[0, 0].sum() < m[0, 0].sum() < di[0, 0].sum()


def test_random_subsample_semantics():
    """A subset of the valid rows, a kept share within 5 binomial standard
    deviations of the fraction, and the same mask for the same seed."""
    n, frac = 20000, 0.05
    rs = np.random.default_rng(3)
    buf = PointBuffer(torch.from_numpy(rs.normal(size=(n, 3)).astype(np.float32)),
                      torch.from_numpy(rs.uniform(size=n) < 0.6))
    out = image.random_subsample(buf, frac, torch.Generator().manual_seed(11))
    again = image.random_subsample(buf, frac, torch.Generator().manual_seed(11))
    other = image.random_subsample(buf, frac, torch.Generator().manual_seed(12))
    keep, valid = out.valid.numpy(), buf.valid.numpy()
    assert out.points is buf.points
    assert not (keep & ~valid).any()
    nv = valid.sum()
    assert abs(keep.sum() - frac * nv) < 5 * np.sqrt(nv * frac * (1 - frac))
    assert torch.equal(out.valid, again.valid)
    assert not torch.equal(out.valid, other.valid)
