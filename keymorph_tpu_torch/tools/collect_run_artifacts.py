"""Assemble committed run artifacts from a run's work directory. Port of
``keymorph_tpu/tools/collect_run_artifacts.py``.

Copies the small, reviewable pieces (args.json, train_log.jsonl, eval
summary JSONs, per-pair metrics JSONs, rendered panels) of a training or
eval run into ``runs/<name>/``; volumes, checkpoints and npys stay behind.

Usage: python -m keymorph_tpu_torch.tools.collect_run_artifacts SRC runs/NAME
"""

from __future__ import annotations

import os
import shutil
import sys

KEEP_NAMES = {"args.json", "train_log.jsonl"}
KEEP_SUFFIXES = (".json", ".png")
SKIP_DIRS = {"checkpoints"}


def collect(src: str, dst: str) -> list:
    """Copy the kept files of ``src`` into ``dst`` (same relative layout);
    returns their paths relative to ``src``."""
    copied = []
    for root, dirs, files in os.walk(src):
        dirs[:] = [d for d in dirs if d not in SKIP_DIRS]
        rel = os.path.relpath(root, src)
        for f in files:
            if f in KEEP_NAMES or f.endswith(KEEP_SUFFIXES):
                out_dir = os.path.join(dst, rel) if rel != "." else dst
                os.makedirs(out_dir, exist_ok=True)
                shutil.copy2(os.path.join(root, f), os.path.join(out_dir, f))
                copied.append(os.path.join(rel, f))
    return copied


if __name__ == "__main__":
    src, dst = sys.argv[1], sys.argv[2]
    out = collect(src, dst)
    print(f"copied {len(out)} files -> {dst}")
    for f in sorted(out)[:20]:
        print(" ", f)
