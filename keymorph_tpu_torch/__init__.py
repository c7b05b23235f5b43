"""keymorph_tpu_torch — the PyTorch/CUDA port of keymorph_tpu.

The port runs keypoint-based 3D registration on an NVIDIA Hopper GPU. Plain
tensor code is PyTorch; every Pallas kernel that keymorph_tpu's main path
runs is a hand-written CUDA C++ kernel for ``sm_90a`` (``csrc/``), built at
first use by :mod:`keymorph_tpu_torch._build` and bound with ``ctypes``.

Each kernel wrapper (``ops/cuda/``) launches its kernel for CUDA tensors and
runs its plain PyTorch version for CPU tensors; the plain version sits in
the same module and is the oracle the kernel is tested against.

Conventions follow keymorph_tpu: keypoints are ``ij``-indexed in [-1, 1],
images are channel-first (B, C, D, H, W), grids are ``xy``-ordered with
``align_corners=False`` voxel mapping, and flow planes are ``ij``-ordered
(B, 3, D, H, W).

Importing this package imports no submodule, no kernel and no JAX.
"""

__version__ = "0.1.0"


def disable_tf32():
    """Run fp32 matmuls and convolutions in full fp32 (TF32 off).

    The torch form of keymorph_tpu's ``Precision.HIGHEST`` pins: geometry
    and the plain conv oracle lose ~3 decimal digits under TF32. Callers
    (scripts, tests) set it once before running the port or its oracles.
    """
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None):
    """The device an entry point runs on: the CUDA card when ``device`` is
    None (raising without one), else what the caller asked for. The CPU is
    used only on request (``device="cpu"``), as the tests do."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "keymorph_tpu_torch runs on a CUDA device and none is available; "
                'pass device="cpu" to run the plain PyTorch versions on the CPU')
        return torch.device("cuda")
    return torch.device(device)
