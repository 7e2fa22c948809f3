"""The port's kernels and their plain versions.

Importing the package registers every serving kernel as an op of the
``torch.ops.mmrp`` namespace (``_build.kernel_op``): what a serving program
traced by ``serve/exported.py`` needs to load and run, without model code.
"""

from mmrp_tpu_torch.ops import (  # noqa: F401
    fused_attention,
    fused_mlp,
    fused_swin_block,
    fused_swin_pair,
    fused_window_attention,
)
