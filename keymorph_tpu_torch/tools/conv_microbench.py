"""Per-conv microbenchmark of the backbone extraction: every conv stage of
the flagship TruncatedUNet3D (f_maps 32, 4 levels, 1 truncated, bf16) at its
real size, one stage at a time, so that the extraction can be attributed
conv by conv. Port of ``keymorph_tpu/tools/conv_microbench.py``'s function
(the same stage list and flags), not of its Mosaic knobs.

Each stage is the executor's GroupNorm + 3^3 conv + ReLU (the norm folded
into the conv as a per-channel affine, ``models/fast_unet.py``), timed in
three forms:

  * ``kernel_ms``: the port's kernel, ``conv3x3_fused_flat`` (a decoder's
    first conv ``conv3x3_fused_flat_upconv``, reading the skip and the
    deeper tensor at half resolution), named by its instantiation
    (``mma<NB>``: the tensor-core kernel with NB output channels a block;
    ``fma``: the FMA kernel below 8 input channels); the 1^3 head is the
    executor's bf16 matmul (PyTorch; it has no hand kernel);
  * ``library_ms``: one bf16 ``F.conv3d`` (cuDNN) of the same operands on
    the materialized input (normalized, upsampled and concatenated first);
  * ``bound_ms``: the least time the card could take, the larger of the
    bytes (input read once, bf16 weights, bf16 output written once) over
    3.35 TB/s and the operations (2 * k^3 * Cin * Cout a voxel) over 989
    TFLOP/s bf16, as ``chip_smoke.py:_conv_bound`` counts them.

and, for every 3^3 stage, its two gradients on a bf16 cotangent of its
output:

  * ``igrad_ms``: the input gradient, ``conv3x3_input_grad`` (its bound is
    the forward's: the same operations, the cotangent read, the gradient
    written);
  * ``wgrad_ms``, ``wgrad_plain_ms``, ``wgrad_library_ms``,
    ``wgrad_bound_ms``: the weight gradient, ``conv3x3_weight_grad``
    (``wgrad<TX>``: the tensor-core kernel and its plane tile's width), its
    plain version (27 tap-sliced fp32 matmuls) and one library call that
    computes the same function (``torch.nn.grad.conv3d_weight`` in bf16 on
    the materialized input, as ``library_ms`` is timed), against the
    operations over 989 TFLOP/s and the bytes (each source read once at its
    own resolution, the cotangent read once, the fp32 gradient written)
    over 3.35 TB/s.

Usage (on the card unless ``--device cpu``):
    python -m keymorph_tpu_torch.tools.conv_microbench [--size 256] [--reps 3]
           [--stages l1c1,l1c2,...] [--device cpu]

One JSON line per stage, then one with the totals (the 1^3 head has no
gradient fields). Timing: CUDA events, the
mean of ``--reps`` calls on fresh seeded inputs (drawn on the device) after a
warm-up; with
``--device cpu`` the plain versions on the host clock ("card": null).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from keymorph_tpu_torch.tools.flops import H100_BF16_PEAK_FLOPS, H100_HBM_BYTES_PER_S

# a decoder's first conv: the deeper tensor's channels, read at half resolution
DEEPER = {"d1c1": 256, "d2c1": 128}


def flagship_stages(size: int):
    """(name, Cin, Cout, spatial) for every conv of the flagship backbone
    (keymorph_tpu's list)."""
    s = size
    st = []
    # encoder: DoubleConv(gcr) per level, MaxPool(2) between levels
    st.append(("l1c1", 1, 16, (s, s, s)))
    st.append(("l1c2", 16, 32, (s, s, s)))
    st.append(("l2c1", 32, 32, (s // 2,) * 3))
    st.append(("l2c2", 32, 64, (s // 2,) * 3))
    st.append(("l3c1", 64, 64, (s // 4,) * 3))
    st.append(("l3c2", 64, 128, (s // 4,) * 3))
    st.append(("l4c1", 128, 128, (s // 8,) * 3))
    st.append(("l4c2", 128, 256, (s // 8,) * 3))
    # decoders (truncated=1): sum/concat joins then DoubleConv(decoder)
    st.append(("d1c1", 384, 128, (s // 4,) * 3))
    st.append(("d1c2", 128, 128, (s // 4,) * 3))
    st.append(("d2c1", 192, 64, (s // 2,) * 3))
    st.append(("d2c2", 64, 64, (s // 2,) * 3))
    st.append(("head", 64, 128, (s // 2,) * 3))  # 1x1 conv
    return st


def conv_flops(cin, cout, spatial, k=3):
    return 2 * int(np.prod(spatial)) * (k**3 if k == 3 else 1) * cin * cout


def bound(cin, cout, spatial, k=3):
    """(ms, "bytes" or "operations"): the stage's input (bf16) read once,
    its bf16 weights, its bf16 output written once, over the memory rate;
    its operations over the bf16 tensor-core peak."""
    n = int(np.prod(spatial))
    nbytes = 2 * (n * cin + k ** 3 * cin * cout + n * cout)
    tb = nbytes / H100_HBM_BYTES_PER_S
    to = conv_flops(cin, cout, spatial, k) / H100_BF16_PEAK_FLOPS
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def wgrad_bound(ca, cb, cout, spatial, lowres=False):
    """(ms, "bytes" or "operations") of a 3^3 conv's weight gradient over
    the sources [ca | cb] channels: each source (bf16) read once at its own
    resolution (``cb`` at half resolution with ``lowres``), the cotangent
    (bf16) read once, the fp32 gradient written once; the forward's
    operations."""
    n = int(np.prod(spatial))
    nb = n // 8 if lowres else n
    cin = ca + cb
    tb = (2 * (n * ca + nb * cb + n * cout) + 4 * 27 * cin * cout) / H100_HBM_BYTES_PER_S
    to = conv_flops(cin, cout, spatial) / H100_BF16_PEAK_FLOPS
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def stage_record(name, cin, cout, spatial, reps, device, gen):
    """One stage's record: kernel, library and bound times, and the
    kernel's instantiation. Inputs and weights are normal draws of ``gen``
    (a ``torch.Generator`` on ``device``)."""
    import torch
    import torch.nn.functional as F

    from keymorph_tpu_torch.ops.cuda import conv3d
    from keymorph_tpu_torch.tools import mean_ms

    Z, Y, X = spatial
    k = 1 if name == "head" else 3
    up = name in DEEPER
    ca, cb = (cin - DEEPER[name], DEEPER[name]) if up else (cin, 0)
    half = (Z // 2, Y // 2, X // 2)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def bf16(*shape):
        return normal(*shape).to(torch.bfloat16)

    w = normal(k, k, k, cin, cout) / float(np.sqrt(k ** 3 * cin))
    scale = torch.rand(cin, generator=gen, device=device) + 0.5
    shift = normal(cin) * 0.2
    inputs = [(bf16(Z, ca, Y * X), bf16(half[0], cb, half[1] * half[2]) if up else None)
              for _ in range(reps)]
    stats = name.endswith("c1")  # the executor's first conv feeds the second's GroupNorm

    if k == 1:
        hw = w[0, 0, 0].to(torch.bfloat16).float()

        def kernel(xa, xb):
            return torch.matmul(xa.float().transpose(1, 2), hw)

        kind = "matmul (PyTorch)"
    else:
        def kernel(xa, xb):
            if xb is None:
                return conv3d.conv3x3_fused_flat(xa, spatial, w, scale, shift, emit_stats=stats)
            return conv3d.conv3x3_fused_flat_upconv(xa, xb, spatial, w, scale, shift,
                                                    emit_stats=stats)

        kind = "fma" if cin < conv3d.FMA_BELOW else f"mma<{conv3d.n_block(cout)}>"

    rhs = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous()

    def library_input(xa, xb):
        full = xa if xb is None else torch.cat(
            [xa, conv3d.upsample_nearest_flat(xb, half, spatial)], dim=1)
        u = full.float() * scale[None, :, None] + shift[None, :, None]
        return u.to(torch.bfloat16).reshape(Z, cin, Y, X).permute(1, 0, 2, 3)[None].contiguous()

    lib_inputs = [(library_input(*x),) for x in inputs]

    def library(x):
        return F.conv3d(x, rhs, padding=k // 2)

    with torch.no_grad():
        kernel_ms, timer = mean_ms(kernel, inputs, device)
        library_ms, _ = mean_ms(library, lib_inputs, device)
    b_ms, b_by = bound(cin, cout, spatial, k)
    tflops = conv_flops(cin, cout, spatial, k) / 1e9
    row = {"stage": name, "cin": cin, "cout": cout, "spatial": list(spatial), "k": k,
           "form": "upconv" if up else "flat", "kernel": kind, "kernel_ms": kernel_ms,
           "kernel_tflops": tflops / kernel_ms, "library_ms": library_ms,
           "bound_ms": b_ms, "bound_by": b_by, "timer": timer}
    if k == 1:
        return row
    grads = [(xa, xb, bf16(Z, cout, Y * X)) for xa, xb in inputs]

    def input_grad(xa, xb, g_v):
        return conv3d.conv3x3_input_grad(g_v, spatial, w, ca if up else None)

    def weight_grad(xa, xb, g_v):
        return conv3d.conv3x3_weight_grad(xa, xb, spatial, g_v, scale, shift, up)

    def weight_grad_plain(xa, xb, g_v):
        return conv3d._weight_grad_plain(xa, xb, spatial, g_v, scale, shift, up)

    lib_grads = [(library_input(xa, xb),
                  g_v.reshape(Z, cout, Y, X).permute(1, 0, 2, 3)[None].contiguous())
                 for xa, xb, g_v in grads]

    def weight_grad_library(u, g):
        return torch.nn.grad.conv3d_weight(u, (cout, cin, 3, 3, 3), g, padding=1)

    with torch.no_grad():
        row["igrad_ms"], _ = mean_ms(input_grad, grads, device)
        row["wgrad_ms"], _ = mean_ms(weight_grad, grads, device)
        row["wgrad_plain_ms"], _ = mean_ms(weight_grad_plain, grads, device)
        row["wgrad_library_ms"], _ = mean_ms(weight_grad_library, lib_grads, device)
    row["wgrad_kernel"] = f"wgrad<{conv3d.weight_grad_plan(spatial, ca, cb, cout)['tx']}>"
    row["wgrad_bound_ms"], row["wgrad_bound_by"] = wgrad_bound(ca, cb, cout, spatial, up)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--stages", default=None, help="comma list; default all")
    ap.add_argument("--device", type=str, default=None,
                    help='default: the CUDA card; "cpu" runs the plain versions, host clock')
    args = ap.parse_args(argv)

    from keymorph_tpu_torch import disable_tf32, resolve_device
    from keymorph_tpu_torch.tools import card

    device = resolve_device(args.device)
    disable_tf32()
    name_of_card = card(device)
    wanted = set(args.stages.split(",")) if args.stages else None
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for name, cin, cout, spatial in flagship_stages(args.size):
        if wanted and name not in wanted:
            continue
        row = stage_record(name, cin, cout, spatial, args.reps, device, gen)
        row["card"] = name_of_card
        rows.append(row)
        print(json.dumps(row), flush=True)
    total = {"total": True, "stages": len(rows), "size": args.size, "card": name_of_card,
             **{k: sum(r.get(k, 0.0) for r in rows)
                for k in ("kernel_ms", "library_ms", "bound_ms", "igrad_ms", "wgrad_ms",
                          "wgrad_plain_ms", "wgrad_library_ms", "wgrad_bound_ms")}}
    print(json.dumps(total), flush=True)
    return rows, total


if __name__ == "__main__":
    main()
