"""The import guard: what a run loads holds no JAX and no keymorph_tpu
(top-level names compared whole: keymorph_tpu_torch is the program under
test), and the reference loads nothing of the program."""

import json
import subprocess
import sys

from kmbench.registry import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "keymorph_tpu"}

RUN_ALL = """
import json, sys
from pathlib import Path
from kmbench import calibrate, run, registry
small = {"img_size": [16, 16, 16], "f_maps": 8, "num_keypoints": 8, "max_train_keypoints": 4}
for cell in ("serve-full-tps1", "train-half-tps"):
    run.execute(cell, 3, 0.2, 1, device="cpu", config=small)
for path in sorted((registry.PACKAGE / "metrics").glob("*.py")):
    registry.load(path)
for path in sorted((registry.PACKAGE / "drivers").glob("*.py")):
    registry.load(path)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_ONLY = """
import json, sys
import kmbench.judge, kmbench.inputs, kmbench.counts, kmbench.readings
import kmbench.reference.unet, kmbench.reference.geometry, kmbench.reference.train
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code):
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _top_level(RUN_ALL)
    assert "keymorph_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE_ONLY)
    assert "keymorph_tpu_torch" not in loaded
    assert not loaded & FORBIDDEN


def test_the_guard_compares_whole_names(monkeypatch):
    from types import SimpleNamespace

    from kmbench import run

    loaded = {"torch": 1, "keymorph_tpu_torch.models": 1, "keymorph_tpu_torchx": 1}
    monkeypatch.setattr(run, "sys", SimpleNamespace(modules=loaded))
    assert run.forbidden_modules() == []
    loaded.update({"jax.numpy": 1, "keymorph_tpu.ops": 1})
    assert run.forbidden_modules() == ["jax", "keymorph_tpu"]
