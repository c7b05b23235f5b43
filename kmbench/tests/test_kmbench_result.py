"""The result line's schema, on the CPU with a small configuration (the
plain versions of the program's kernels), and the refusals: no card, and a
checkout that holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from kmbench import run
from kmbench.registry import ROOT


@pytest.mark.parametrize("cell,trace", [("serve-full-tps1", 0), ("serve-full-evalsweep", 1),
                                        ("train-half-tps", 0), ("train-half-tps", 1)])
def test_result_line(cell, trace, small):
    result, rows = run.execute(cell, 2 ** 31 + 7, 0.3, trace, device="cpu", config=small)
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert isinstance(line["correct"], bool) and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}
    names = [name for name, _, _ in rows]
    assert names == list(line["check"])
    assert all(set(v) == {"value", "limit"} for v in line["check"].values())
    if trace:
        # no device on the CPU: no device share is reported, nothing reads 0
        assert not any(k.startswith(("conv_roofline", "idle_share")) for k in line["metrics"])
        assert line["device"]["busy_s"] == 0.0
    else:
        assert "setup_s" in line["metrics"]
        e2e = "train_step_ms" if cell.startswith("train") else "regs_per_s"
        assert line["metrics"][e2e]["value"] > 0


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert run.main(["--workload", "serve-full-tps1", "--seed", "1", "--seconds", "1"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and kmbench/ has no program
    to run: the run fails and prints nothing on standard output."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "kmbench", tmp_path / "kmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from kmbench import run; run.execute('serve-full-tps1', 1, 0.3, 0, device='cpu', "
            "config={'img_size': [16, 16, 16], 'f_maps': 8, 'num_keypoints': 8})")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "keymorph_tpu_torch" in p.stderr
    p = subprocess.run([sys.executable, "-m", "kmbench.run", "--workload", "serve-full-tps1",
                        "--seed", "1", "--seconds", "1"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
