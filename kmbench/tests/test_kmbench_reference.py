"""The plain reference against the program's plain path on the CPU, at a
small size: the same semantics, stage by stage. Where both compute in
float32 the stages agree to rounding; the bf16 extractor's heatmaps agree
but for values that a different order of fp32 sums rounds to the
neighbouring bf16 value (one ulp), and those flips propagate."""

import pytest
import torch

from kmbench import inputs, program
from kmbench.drivers.serve import param_specs
from kmbench.reference import geometry, train, unet
from kmbench.reference.precision import CONTROL, REFERENCE, to_tf32

CFG = {"backbone": "truncatedunet", "f_maps": 8, "num_levels_for_unet": 4,
       "num_truncated_layers_for_truncatedunet": 1, "layer_order": "gcr", "num_groups": 8,
       "num_keypoints": 16, "kp_layer": "com", "precision": {"backbone": "bf16"}}
S = 32


def _net_and_inputs(seed=5):
    w = inputs.make_weights(seed, param_specs(CFG), "cpu")
    return w, program.keypoint_net(CFG, w, "cpu"), inputs.make_pool(seed, 2, S, "cpu")


def test_param_specs_are_the_programs_state_dict():
    w, net, _ = _net_and_inputs()
    sd = net.state_dict()
    assert {f"backbone.{k}": tuple(v.shape) for k, v in w.items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    assert all(torch.equal(sd[f"backbone.{k}"], v) for k, v in w.items())


def test_extractor_matches_to_bf16_rounding():
    w, net, pool = _net_and_inputs()
    with torch.no_grad():
        feat = net.features(pool[:1]).float().permute(0, 4, 1, 2, 3)
        kp = net.keypoints_from_features(net.features(pool[:1]))
        heat = unet.heatmaps(w, pool[:1], 4, 1, REFERENCE)
    d = (feat - heat).abs()
    ulp = 2.0 ** (torch.floor(torch.log2(heat.abs().max())) - 7)  # at the largest value
    assert float(d.max()) <= 4 * ulp  # a semantic difference would be of the order of the values
    assert float((kp - unet.center_of_mass(heat)).abs().max()) < 1e-2  # a tenth of a heatmap voxel
    # the centre of mass alone, on the same heatmaps, to float32 rounding
    from keymorph_tpu_torch.models.layers import center_of_mass

    same = center_of_mass(heat.permute(0, 2, 3, 4, 1).to(torch.bfloat16))
    assert float((same - unet.center_of_mass(heat)).abs().max()) < 1e-6


@pytest.mark.parametrize("transform", ["rigid", "affine", "tps_10", "tps_1", "tps_0"])
def test_fits_and_flows(transform):
    from keymorph_tpu_torch.models.keymorph import align_pair, parse_transform_type

    g = torch.Generator().manual_seed(3)
    pf = torch.rand(1, 12, 3, generator=g) * 1.2 - 0.6
    pm = pf + 0.05 * torch.randn(1, 12, 3, generator=g)
    kind, lmbda = parse_transform_type(transform)
    lm = None if lmbda is None else torch.tensor([lmbda])
    planes = align_pair(pf, pm, kind, (S,) * 3, lmbda=lm, compute_grid="planes")["planes"]
    ref = geometry.flow(transform, pf, pm, (S,) * 3, REFERENCE)
    assert float((planes - ref).abs().max()) < 2e-5
    control = geometry.flow(transform, pf, pm, (S,) * 3, CONTROL)
    assert float((control - ref).abs().max()) > 1e-5  # TF32 operands move it


def test_warp_and_augmentation():
    from keymorph_tpu_torch import augment
    from keymorph_tpu_torch.ops.resample import align_planes

    pool = inputs.make_pool(4, 2, S, "cpu")
    g = torch.Generator().manual_seed(4)
    planes = (geometry.grid_points((S,) * 3, "cpu").T.reshape(1, 3, S, S, S)
              + 0.05 * torch.randn(1, 3, S, S, S, generator=g)) * 1.05
    assert float((align_planes(planes, pool[1:]) - geometry.warp(pool[1:], planes, REFERENCE))
                 .abs().max()) < 1e-6
    params = (torch.tensor([[1.1, 0.9, 1.05]]), torch.tensor([[0.1, -0.05, 0.02]]),
              torch.tensor([[0.3, -0.2, 1.0]]), torch.tensor([[0.05, -0.02, 0.01, 0.0, 0.03, -0.04]]))
    ours = augment.affine_augment_with_params(pool[1:], params)
    assert float((ours - geometry.augment(pool[1:], *params, REFERENCE)).abs().max()) < 1e-5


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0 - 2 ** -23])
    assert to_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -10, -3.0]


def test_training_step_matches():
    """The program's first step against the reference's following the
    program's keypoints: the loss to float32 rounding, the gradient leaf by
    leaf in direction and, at the median leaf, in norm; and the keypoints
    themselves to the extractor's rounding."""
    from keymorph_tpu_torch.training import train as program_train

    from kmbench import judge
    from kmbench.drivers.train import recipe

    w, net, pool = _net_and_inputs(seed=7)
    cfg = dict(CFG, loss_fn="mse", transform_type="tps_loguniform", max_train_keypoints=8,
               max_train_tps_lmbda=10.0, img_size=[S] * 3, batch_size=1, lr=3e-6)
    config = recipe(cfg)
    state = program_train.TrainState.create(net, program_train.make_optimizer(config, net))
    step = program_train.make_train_step(net, config)
    draw = inputs.train_draws(7, 1, 16, 8, 10.0, (0.2, 0.2, 3.1416, 0.1), "cpu")
    aug = tuple(draw[k] for k in ("scale", "offset", "theta", "shear"))
    points = []
    net.register_forward_hook(lambda m, a, out: points.append((out[0].detach(), out[1].detach())))
    _, metrics = step(state, None, pool[:1], pool[1:], None, None, 1.0, lmbda=draw["lmbda"],
                      keypoint_idx=draw["keypoint_idx"][0], aug_params=aug)
    names = program.leaf_names(net)
    grads = {names[p]: state.optimizer.state[p]["exp_avg"] / 0.1 for p in net.parameters()}
    losses, first, _, own = train.run(w, [(pool[:1], pool[1:])], draw, 3e-6, 1, 4, 1, REFERENCE,
                                      forced=points)
    assert abs(float(metrics["loss"]) - losses[0]) / losses[0] < 1e-6
    assert max(float((p - r).abs().max()) for p, r in zip(points[0], own[0])) < 1e-2
    cos = sorted(float((grads[k].flatten() @ first[k].flatten())
                       / (grads[k].norm() * first[k].norm())) for k in first)
    assert cos[len(cos) // 2] > 0.99
    gaps = judge.leaf_gaps({k: float(g.norm()) for k, g in grads.items()},
                           {k: float(g.norm()) for k, g in first.items()})
    assert sorted(gaps.values())[len(gaps) // 2] < 1e-2
