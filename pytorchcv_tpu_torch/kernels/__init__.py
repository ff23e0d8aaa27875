"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each in its
own module beside its plain PyTorch version: ``preprocess`` (K1),
``int8_conv`` (K2), ``stem`` (K3, and ``maxpool_i8``), ``flash_attention``
(K4), ``deform_patch`` (K5, ``deform_sample``). A wrapper runs its kernel on
CUDA tensors and its plain version on CPU tensors; ``LAUNCHES`` counts
kernel launches per wrapper.
"""

from ._build import LAUNCHES, reset_launch_counts

__all__ = ["LAUNCHES", "reset_launch_counts"]
