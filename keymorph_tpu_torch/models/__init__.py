"""Backbone, keypoint head and registration pipeline of the port."""
from keymorph_tpu_torch.models.layers import (  # noqa: F401
    center_of_mass,
    center_of_mass_plain,
    CenterOfMass,
    LinearRegressor,
    ConvBlock,
)
