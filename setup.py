"""Packaging for keymorph_tpu (reference setup.py equivalent, with a real
native extension: libkmio is built via the Makefile in keymorph_tpu/native)."""

import subprocess
from pathlib import Path

from setuptools import Command, find_packages, setup
from setuptools.command.build_py import build_py


class BuildNative(Command):
    """Build libkmio.so (C++ IO fast path) via its Makefile."""

    description = "build the native IO library"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        native_dir = Path(__file__).parent / "keymorph_tpu" / "native"
        try:
            subprocess.check_call(["make", "-C", str(native_dir)])
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"WARNING: native build failed ({e}); pure-Python fallbacks will be used")


class BuildPyWithNative(build_py):
    def run(self):
        self.run_command("build_native")
        super().run()


setup(
    name="keymorph_tpu",
    version="0.1.0",
    description="TPU-native keypoint-based medical image registration (JAX/Flax/Pallas)",
    packages=find_packages(include=["keymorph_tpu", "keymorph_tpu.*",
                                    "keymorph_tpu_torch", "keymorph_tpu_torch.*"]),
    package_data={
        "keymorph_tpu.native": ["*.so", "*.cpp", "Makefile"],
        # CUDA sources of the PyTorch port, compiled with nvcc at first use
        "keymorph_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "scipy",
    ],
    extras_require={
        "viz": ["matplotlib"],
        "test": ["pytest", "torch"],
    },
    cmdclass={"build_native": BuildNative, "build_py": BuildPyWithNative},
    entry_points={
        "console_scripts": [
            "keymorph-tpu-run=keymorph_tpu.cli.run:main",
            "keymorph-tpu-register=keymorph_tpu.cli.register:main",
        ]
    },
)
