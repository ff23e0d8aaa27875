"""The tree checks of the dense int8 pipelines against the JAX package's,
on the zoo's trees (full size: the port's under ``FakeTensorMode``, the JAX
package's as shape trees): ``is_plain_resnet_trunk`` and
``is_seg_resnetd_backbone`` give JAX's verdict on every pose, detection and
segmentation family and on classifiers of the trunks' families.
"""

import pytest
from torch._subclasses.fake_tensor import FakeTensorMode

import pytorchcv_tpu as ptc
from pytorchcv_tpu.quant.seg_backbone_int8 import (
    is_plain_resnet_trunk as jax_is_plain_trunk,
    is_seg_resnetd_backbone as jax_is_seg_backbone)
from pytorchcv_tpu_torch.models import get_constructor
from pytorchcv_tpu_torch.quant import (is_plain_resnet_trunk,
                                       is_seg_resnetd_backbone)


# The tree checks' verdicts: every pose and detection name passes the plain
# trunk's check and fails the segmentation backbone's; every segmentation
# name the reverse; ResNet(D), Fast-SE-ResNet and ResNet classifiers have no
# ``backbone`` and fail both.
_VERDICT_NAMES = [
    "simplepose_resnet18_coco", "simplepose_resnet50b_coco",
    "simplepose_resnet101b_coco", "simplepose_resnet152b_coco",
    "centernet_resnet18_voc", "centernet_resnet50b_coco",
    "centernet_resnet101b_voc", "alphapose_fastseresnet101b_coco",
    "pspnet_resnetd50b_voc", "deeplabv3_resnetd152b_voc",
    "fcn8sd_resnetd101b_coco", "danet_resnetd50b_cityscapes",
    "fastseresnet101b", "resnetd50b", "resnet50b"]


@pytest.mark.parametrize("name", _VERDICT_NAMES)
def test_tree_check_verdicts_match_jax(name):
    shapes = ptc.get_model(name, init=False).shape_variables()
    with FakeTensorMode():
        tm = get_constructor(name)()
        got = (is_plain_resnet_trunk(tm), is_seg_resnetd_backbone(tm))
    want = (jax_is_plain_trunk(shapes), jax_is_seg_backbone(shapes))
    assert got == want
    family = get_constructor(name).__module__.rsplit(".", 1)[-1]
    assert got == {"simplepose_coco": (True, False),
                   "centernet": (True, False),
                   "alphapose_coco": (True, False)}.get(
        family, (False, family in ("pspnet", "deeplabv3", "fcn8sd",
                                   "danet")))
