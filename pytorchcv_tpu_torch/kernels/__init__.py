"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each in its
own module beside its plain PyTorch version: ``preprocess`` (K1),
``int8_conv`` (K2), ``stem`` (K3, and ``maxpool_i8``), ``flash_attention``
(K4), ``deform_patch`` (K5, ``deform_sample``), ``dwconv`` (K6,
``dwconv2d_bn_act``), ``attention`` (K7, ``fused_window_attention``),
``fused_bottleneck`` (K8, ``fused_bottleneck_chain``), ``stem_conv`` (K9,
``stem_conv7x7_s2``), ``patch_probe`` (K10, ``patch_window_sum``),
``se_tail`` (K11, the SE unit's tail), ``dwconv_i8`` (K12, the int8
depthwise conv), ``preact`` (K13, the PreResNet stream step). A
wrapper runs its kernel on CUDA tensors and its plain version on CPU
tensors, and refuses a call that autograd would record (no kernel has a
backward); ``LAUNCHES`` counts kernel launches per wrapper.
"""

from ._build import LAUNCHES, reset_launch_counts

__all__ = ["LAUNCHES", "reset_launch_counts"]
