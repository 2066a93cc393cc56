"""fairdiff_torch.utils.resize against `jax.image.resize` (antialias on, the
guidance zoo's calls): nearest, bilinear and cubic, up and down, values and
gradients (the VJP of a seeded cotangent). Float32 from one numpy seed;
tolerance 1e-5 absolute on values and gradients of O(1): the same weights
summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairdiff_torch.utils import resize as tresize

torch.set_num_threads(1)

CASES = [
    ("nearest", (2, 8, 8, 4), (2, 16, 16, 4)),  # the detector's FPN upsample
    ("nearest", (1, 7, 9, 3), (1, 16, 5, 3)),
    ("bilinear", (2, 64, 64, 3), (2, 32, 32, 3)),  # img_size_small, downsampling
    ("bilinear", (1, 32, 32, 3), (1, 28, 28, 3)),  # 256 -> 224 in miniature
    ("bilinear", (1, 20, 20, 3), (1, 56, 56, 3)),
    ("cubic", (37, 37, 8), (16, 16, 8)),  # DINOv2's position grid 37 -> 16
    ("cubic", (4, 4, 8), (2, 2, 8)),
    ("cubic", (5, 6, 3), (13, 11, 3)),
]


@pytest.mark.parametrize("method,shape,out", CASES)
def test_resize_matches_jax(method, shape, out):
    rng = np.random.default_rng(len(shape) + shape[1])
    x = rng.normal(size=shape).astype(np.float32)
    ct = rng.normal(size=out).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax.image.resize(a, out, method), jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_()
    got = tresize.resize(tx, out, method)
    assert got.shape == out
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_grad), atol=1e-5)


def test_resize_differs_from_interpolate_where_jax_antialiases():
    """The reason the module exists: F.interpolate's bilinear does not
    antialias a 2x downsample, jax's does."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 3, 16, 16)).astype(np.float32))
    plain = torch.nn.functional.interpolate(x, size=(8, 8), mode="bilinear", align_corners=False)
    ours = tresize.resize(x, (1, 3, 8, 8), "bilinear")
    assert (plain - ours).abs().max() > 0.1


def test_resize_rejects_bad_arguments():
    x = torch.zeros(2, 4, 4, 3)
    with pytest.raises(ValueError, match="rank"):
        tresize.resize(x, (4, 4, 3), "bilinear")
    with pytest.raises(ValueError, match="method"):
        tresize.resize(x, (2, 8, 8, 3), "area")
