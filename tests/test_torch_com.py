"""The port's center-of-mass head (``models/layers.py``: ``center_of_mass``
with ``indexing`` and the ``CenterOfMass`` module) against keymorph_tpu's on
the CPU, in 2D and 3D, on seeded heatmaps in bf16 and fp32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keymorph_tpu.models import CenterOfMass as JCenterOfMass
from keymorph_tpu.models import center_of_mass as jcenter_of_mass
from keymorph_tpu_torch.models import CenterOfMass, center_of_mass

ABS = 1e-6   # fp32 sums of the same addends in another order
SHAPES = {2: (2, 17, 12, 5), 3: (2, 9, 14, 11, 6)}   # (B, *spatial, C), channel-last


def _heatmaps(dim, dtype, seed=0):
    """Seeded heatmaps (B, *spatial, C), half of them negative (the ReLU
    drops those), in both packages' ``dtype``."""
    x = np.random.default_rng(seed).normal(size=SHAPES[dim]).astype(np.float32)
    t = torch.tensor(x).to(dtype)
    j = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))
    return t, j


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("indexing", ["ij", "xy"])
def test_center_of_mass_matches_jax(dim, dtype, indexing):
    """The function and the module give keymorph_tpu's coordinates within
    ABS, (B, C, dim) fp32 in [-1, 1]."""
    t, j = _heatmaps(dim, dtype)
    want = np.asarray(jcenter_of_mass(j, indexing))
    got = center_of_mass(t, indexing)
    mod = CenterOfMass(indexing)(t)
    jmod = np.asarray(JCenterOfMass(indexing).apply({}, j))
    assert got.dtype == torch.float32 and got.shape == (SHAPES[dim][0], SHAPES[dim][-1], dim)
    assert float(got.abs().max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=ABS, rtol=0)
    np.testing.assert_allclose(mod.numpy(), jmod, atol=ABS, rtol=0)
    assert torch.equal(mod, got)


@pytest.mark.parametrize("dim", [2, 3])
def test_xy_is_ij_reversed_and_ij_is_the_default(dim):
    """``"xy"`` is the ``"ij"`` coordinates in reverse order, bit for bit,
    and the default is ``"ij"`` (the served pairs' path, unchanged); no
    other indexing is taken."""
    t, _ = _heatmaps(dim, torch.bfloat16, seed=1)
    ij = center_of_mass(t, "ij")
    assert torch.equal(center_of_mass(t), ij) and torch.equal(CenterOfMass()(t), ij)
    assert torch.equal(center_of_mass(t, "xy"), ij.flip(-1))
    assert not list(CenterOfMass().parameters())
    with pytest.raises(ValueError, match="indexing"):
        center_of_mass(t, "zyx")
    with pytest.raises(ValueError, match="indexing"):
        CenterOfMass("zyx")
