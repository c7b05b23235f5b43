"""Profile the canonical 128^3 training step and print the device time by
kernel: the training counterpart of ``extract_trace.py``, and the
torch.profiler form of ``keymorph_tpu/tools/train_step_trace.py``.

The step is ``tools/train_step_bench.py:build``'s (TruncatedUNet3D f_maps
32, 4 levels, 1 truncated, bf16; 128 keypoints, ``tps_loguniform``, MSE,
64-keypoint subsample, Adam 3e-6, batch 1), one warm-up step and then 3
steps on varied moving volumes under
:func:`keymorph_tpu_torch.tools.trace_summary.profile_fn`.

Usage (on the card unless ``--device cpu``, where no device time exists):
    python -m keymorph_tpu_torch.tools.train_step_trace [S] [top_n]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("S", nargs="?", type=int, default=128)
    ap.add_argument("top_n", nargs="?", type=int, default=40)
    ap.add_argument("--device", type=str, default=None)
    args = ap.parse_args(argv)

    import torch

    import keymorph_tpu_torch
    from keymorph_tpu_torch import resolve_device
    from keymorph_tpu_torch.tools import card
    from keymorph_tpu_torch.tools.extract_trace import report
    from keymorph_tpu_torch.tools.train_step_bench import build
    from keymorph_tpu_torch.tools.trace_summary import profile_fn
    from keymorph_tpu_torch.training.train import make_train_step

    device = resolve_device(args.device)
    if device.type == "cuda":
        keymorph_tpu_torch.disable_tf32()
    net, config, state, imgs = build(args.S, device=device)
    step = make_train_step(net, config)
    gen = torch.Generator().manual_seed(1)
    img_f, moving = imgs[0], imgs[1:]
    state, _ = step(state, gen, img_f, moving[0], None, None, 1.0)  # warm-up

    def run():
        st = state
        for img_m in moving:
            st, m = step(st, gen, img_f, img_m, None, None, 1.0)
        return m

    m, summary = profile_fn(run, top_n=args.top_n)
    report(f"train step {args.S}^3 (loss {float(m['loss']):.6f})", summary, len(moving),
           card(device))
    return summary


if __name__ == "__main__":
    main()
