"""Native (C++) host helpers of the data layer, built at first use
(:mod:`keymorph_tpu_torch.native.kmio`). Importing this package builds
nothing."""
