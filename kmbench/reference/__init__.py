"""The plain reference of KeyMorph's registration and training step.

Plain PyTorch in float32 (TF32 off) where the configuration states float32,
and bfloat16 operands with float32 sums where it states bfloat16, written
from the published algorithm (the KeyMorph reference: a DoubleConv U-Net
with GroupNorm, a centre-of-mass head, the closed-form affine, rigid and
thin-plate-spline fits, ``grid_sample``'s trilinear warp with border
padding, MSE and Adam). It imports nothing of the program under test and
takes nothing the program made: the benchmark hands it the weights and
volumes it drew, and the program's answers only to judge them.

Every function takes a :class:`~kmbench.reference.precision.Precision`;
one step below the configuration's (fp8 operands for the bf16 convs, TF32
operands for the fp32 products) is the control that the output check must
reject.
"""
