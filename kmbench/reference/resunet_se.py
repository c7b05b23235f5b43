"""The residual keypoint extractor: ResidualUNetSE3D (pytorch-3dunet's
``unet3d/model.py``, Wolny et al., eLife 2020), a 1x1 head and the centre of
mass of each ReLU'd heatmap.

A block (pytorch-3dunet's ``ResNetBlockSE``; the residual unit of Lee et
al., arXiv:1706.00120) is: a 1x1 conv with bias where the widths change
(``conv1``, the residual), GroupNorm -> 3x3x3 conv -> ReLU (``conv2``),
GroupNorm -> 3x3x3 conv (``conv3``), the residual sum, the ReLU, and the
concurrent spatial and channel squeeze-and-excitation gate (Roy, Navab and
Wachinger, MICCAI 2018; reduction ratio 1): ``max(x * g_c, x * g_s)`` with
g_c = sigmoid(fc2(relu(fc1(mean of x)))) per channel and g_s = sigmoid of a
1x1 conv to one channel per voxel. A 2x max-pool precedes every encoder but
the first; a decoder upsamples by a transposed 3x3x3 conv (stride 2, padding
1, output padding 1, with bias), crops it to the skip and adds the skip,
then runs a block of its width (no lift).

Weights are a dict under the published ``state_dict`` names
(``encoders.i.basic_module.{conv1, conv2, conv3}.*``,
``...se_module.{cSE.fc1, cSE.fc2, sSE.conv}.*``,
``decoders.j.upsampling.upsample.*``, ``final_conv.*``); conv weights
(Cout, Cin, k, k, k), transposed-conv weights (Cin, Cout, 3, 3, 3).
Channel-first (1, C, D, H, W) float32 tensors hold bf16 values: the input
and every stored activation (each conv's, linear's, sigmoid's, product's and
sum's result) are rounded to bf16; GroupNorm takes fp32 statistics (eps
1e-5; one group below 8 channels, else 8); the operands of every conv, the
transposed convs and the gate's linears and 1x1 conv are rounded to the
configuration's precision and summed in fp32; their biases are stored in
bf16, the head's bias stays fp32. The head's output is stored in bf16 and
its centre of mass summed in fp32; both run slab by slab along D, so that
no (K, D, H, W) tensor exists (256 heatmaps at 256^3 would be 17 GB in
fp32).

Departures from the module's equations, each a matter of arithmetic order
only: GroupNorm is ``F.group_norm`` (a two-pass variance, the normalization
and the affine as torch applies them), where the module takes E[x^2] -
mean^2; the spatial mean of the squeeze is torch's fp32 mean.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kmbench.reference.precision import Precision, store
from kmbench.reference.unet import max_pool2, widths

SLAB = 8  # planes along D of the head and its centre of mass at a time


def param_specs(f_maps: int, num_levels: int, keypoints: int, se: bool = True):
    """[(name, shape, kind)] of the extractor's parameters, in a fixed
    order; kind ``conv``, ``scale`` or ``shift`` (``inputs.make_weights``)."""
    specs = []

    def single(prefix, c):
        specs.append((f"{prefix}.conv.weight", (c, c, 3, 3, 3), "conv"))
        specs.append((f"{prefix}.groupnorm.weight", (c,), "scale"))
        specs.append((f"{prefix}.groupnorm.bias", (c,), "shift"))

    def block(prefix, cin, cout):
        if cin != cout:
            specs.append((f"{prefix}.conv1.weight", (cout, cin, 1, 1, 1), "conv"))
            specs.append((f"{prefix}.conv1.bias", (cout,), "shift"))
        single(f"{prefix}.conv2", cout)
        single(f"{prefix}.conv3", cout)
        if se:
            for fc in ("fc1", "fc2"):
                specs.append((f"{prefix}.se_module.cSE.{fc}.weight", (cout, cout), "conv"))
                specs.append((f"{prefix}.se_module.cSE.{fc}.bias", (cout,), "shift"))
            specs.append((f"{prefix}.se_module.sSE.conv.weight", (1, cout, 1, 1, 1), "conv"))
            specs.append((f"{prefix}.se_module.sSE.conv.bias", (1,), "shift"))

    fm = widths(f_maps, num_levels)
    cin = 1
    for i, ch in enumerate(fm):
        block(f"encoders.{i}.basic_module", cin, ch)
        cin = ch
    rev = fm[::-1]
    for j in range(len(rev) - 1):
        out = rev[j + 1]
        specs.append((f"decoders.{j}.upsampling.upsample.weight", (cin, out, 3, 3, 3), "conv"))
        specs.append((f"decoders.{j}.upsampling.upsample.bias", (out,), "shift"))
        block(f"decoders.{j}.basic_module", out, out)
        cin = out
    specs.append(("final_conv.weight", (keypoints, cin, 1, 1, 1), "conv"))
    specs.append(("final_conv.bias", (keypoints,), "shift"))
    return specs


def _conv(x, w, b, prec: Precision, **kw):
    """A conv of the configuration's operand precision with its bias
    stored in bf16, fp32 sums, the result stored."""
    return store(F.conv3d(prec.conv_operand(x), prec.conv_operand(w),
                          None if b is None else store(b), **kw))


def _linear(x, w, b, prec: Precision):
    return store(F.linear(prec.conv_operand(x), prec.conv_operand(w), store(b)))


def _single(w, prefix, x, prec, relu):
    c = x.shape[1]
    u = F.group_norm(x, 1 if c < 8 else 8, w[f"{prefix}.groupnorm.weight"],
                     w[f"{prefix}.groupnorm.bias"], eps=1e-5)
    v = _conv(u, w[f"{prefix}.conv.weight"], None, prec, padding=1)
    return torch.relu(v) if relu else v


def _scse(w, prefix, x, prec):
    s = x.mean(dim=(2, 3, 4))  # (1, C) fp32
    h = torch.relu(_linear(s, w[f"{prefix}.cSE.fc1.weight"], w[f"{prefix}.cSE.fc1.bias"], prec))
    g_c = store(torch.sigmoid(_linear(h, w[f"{prefix}.cSE.fc2.weight"],
                                      w[f"{prefix}.cSE.fc2.bias"], prec)))
    g_s = store(torch.sigmoid(_conv(x, w[f"{prefix}.sSE.conv.weight"],
                                    w[f"{prefix}.sSE.conv.bias"], prec)))
    return torch.maximum(store(x * g_c[:, :, None, None, None]), store(x * g_s))


def _block(w, prefix, x, prec):
    if f"{prefix}.conv1.weight" in w:
        x = _conv(x, w[f"{prefix}.conv1.weight"], w[f"{prefix}.conv1.bias"], prec)
    y = _single(w, f"{prefix}.conv2", x, prec, relu=True)
    y = _single(w, f"{prefix}.conv3", y, prec, relu=False)
    out = torch.relu(store(y + x))
    if f"{prefix}.se_module.sSE.conv.weight" in w:
        out = _scse(w, f"{prefix}.se_module", out, prec)
    return out


def features(w, img, num_levels: int, prec: Precision):
    """(1, 1, D, H, W) volume -> (1, C, D, H, W) the last decoder's output
    (bf16 values)."""
    x = store(img)
    skips = []
    for i in range(num_levels):
        if i > 0:
            x = max_pool2(x)
        x = _block(w, f"encoders.{i}.basic_module", x, prec)
        skips.append(x)
    for j, skip in enumerate(skips[:-1][::-1]):
        up = store(F.conv_transpose3d(
            prec.conv_operand(x), prec.conv_operand(w[f"decoders.{j}.upsampling.upsample.weight"]),
            store(w[f"decoders.{j}.upsampling.upsample.bias"]), stride=2, padding=1,
            output_padding=1))
        up = up[:, :, : skip.shape[2], : skip.shape[3], : skip.shape[4]]
        if up.shape != skip.shape:
            raise ValueError(f"the upsampled {tuple(up.shape[2:])} cannot join the skip "
                             f"{tuple(skip.shape[2:])}")
        x = _block(w, f"decoders.{j}.basic_module", store(skip + up), prec)
    return x


def keypoints(w, img, num_levels: int, prec: Precision):
    """(1, 1, D, H, W) volume -> (1, K, 3) keypoints, ``ij`` order, in
    [-1, 1]: the head (bf16 operands, fp32 sums, the fp32 bias, stored in
    bf16) and the centre of mass of its ReLU, both slab by slab along D.
    Along an axis of N voxels a keypoint's coordinate is the mass-weighted
    mean of linspace(0, 1, N), mapped by ``* 2 - 1``."""
    x = features(w, img, num_levels, prec)
    _, _, D, H, W = x.shape
    wf = prec.conv_operand(w["final_conv.weight"])
    bias = w["final_conv.bias"].reshape(1, -1, 1, 1, 1)
    K = wf.shape[0]
    m_d = torch.zeros((K, D), device=x.device)
    m_h = torch.zeros((K, H), device=x.device)
    m_w = torch.zeros((K, W), device=x.device)
    for d0 in range(0, D, SLAB):
        heat = store(F.conv3d(prec.conv_operand(x[:, :, d0: d0 + SLAB]), wf) + bias)
        v = torch.relu(heat)[0]  # (K, d, H, W)
        m_d[:, d0: d0 + v.shape[1]] = v.sum(dim=(2, 3))
        m_h += v.sum(dim=(1, 3))
        m_w += v.sum(dim=(1, 2))
        del heat, v
    coords = []
    for m in (m_d, m_h, m_w):
        line = torch.linspace(0.0, 1.0, m.shape[1], device=m.device)
        coords.append((m * line).sum(-1) / (m.sum(-1) + 1e-8))
    return (torch.stack(coords, dim=-1) * 2.0 - 1.0)[None]
