"""What the benchmark takes from the program under test, keymorph_tpu_torch:
its keypoint net, built from the configuration and loaded with the
benchmark's weights. The drivers call the program's public functions
themselves; nothing else of it is imported here.
"""

from __future__ import annotations

import torch


def keypoint_net(cfg: dict, weights: dict, device):
    """The program's ``KeyMorphNet`` for ``cfg``, its parameters copied
    from ``weights`` (the published U-Net names, without the ``backbone.``
    prefix), on ``device``. Built on the meta device, so that no parameter
    is initialised twice."""
    from keymorph_tpu_torch.models.keymorph import KeyMorphNet
    from keymorph_tpu_torch.models.unet import TruncatedUNet3D

    if cfg["backbone"] != "truncatedunet" or cfg["precision"]["backbone"] != "bf16":
        raise ValueError("this builds the bf16 truncatedunet; another backbone's cells "
                         "need a driver that builds it")
    with torch.device("meta"):
        backbone = TruncatedUNet3D(
            out_channels=cfg["num_keypoints"], f_maps=cfg["f_maps"],
            num_levels=cfg["num_levels_for_unet"],
            num_truncated_layers=cfg["num_truncated_layers_for_truncatedunet"],
            layer_order=cfg["layer_order"], num_groups=cfg["num_groups"],
            dtype=torch.bfloat16)
        net = KeyMorphNet(backbone, cfg["num_keypoints"], keypoint_layer=cfg["kp_layer"])
    net = net.to_empty(device=device)
    net.load_state_dict({f"backbone.{k}": v for k, v in weights.items()}, strict=True)
    return net


def leaf_names(net):
    """{parameter: its name in the published U-Net's state_dict}."""
    return {p: name.removeprefix("backbone.") for name, p in net.named_parameters()}
