"""Evaluation-sweep constants. Copy of ``keymorph_tpu/cli/hyperparameters.py``.

The preprocessing pipeline itself is keymorph_tpu_torch.data.Preprocessor
(ToCanonical -> Mask -> Resize -> rescale).
"""

EVAL_METRICS = [
    "mse",
    "softdice",
    "harddice",
    "hausd",
    "jdstd",
    "jdlessthan0",
]

EVAL_UNI_NAMES = [
    ("T1", "T1"),
    ("T2", "T2"),
    ("PD", "PD"),
]

EVAL_MULTI_NAMES = [
    ("T1", "T2"),
    ("T1", "PD"),
    ("T2", "PD"),
]

EVAL_AUGS = [
    "rot0",
    "rot45",
    "rot90",
    "rot135",
    "rot180",
]

EVAL_KP_ALIGNS = [
    "rigid",
    "affine",
    "tps_10",
    "tps_1",
    "tps_0.1",
    "tps_0.01",
    "tps_0",
]
