"""The port's public surface: import hygiene, registry, get_model, and the
serving entry point end to end on CPU tensors."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from pytorchcv_tpu.models import registry as jax_registry
import pytorchcv_tpu_torch as pt
from pytorchcv_tpu_torch.models.propainter_rfc_stream import \
    ProPainterRFCSequencer
from pytorchcv_tpu_torch.models.propainter_stream import (
    ProPainterIPSequencer, ProPainterITSequencer)

torch.set_num_threads(1)


def test_import_leaves_jax_out():
    code = ("import sys, pytorchcv_tpu_torch, pytorchcv_tpu_torch.serve, "
            "pytorchcv_tpu_torch.nn.deform, pytorchcv_tpu_torch.streaming, "
            "pytorchcv_tpu_torch.models.propainter_rfc, "
            "pytorchcv_tpu_torch.models.propainter_rfc_stream, "
            "pytorchcv_tpu_torch.models.efficientnet, "
            "pytorchcv_tpu_torch.kernels.dwconv, "
            "pytorchcv_tpu_torch.kernels.attention, "
            "pytorchcv_tpu_torch.models.propainter, "
            "pytorchcv_tpu_torch.models.propainter_ip, "
            "pytorchcv_tpu_torch.models.propainter_ip_stream, "
            "pytorchcv_tpu_torch.models.propainter_stream, "
            "pytorchcv_tpu_torch.models.raft, "
            "pytorchcv_tpu_torch.models.raft_stream, "
            "pytorchcv_tpu_torch.models.inceptionv3, "
            "pytorchcv_tpu_torch.models.mobilenetv3, "
            "pytorchcv_tpu_torch.kernels.dwconv_i8, "
            "pytorchcv_tpu_torch.quant.mobilenet_int8; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'pytorchcv_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_registry_holds_every_jax_resnet_name():
    """Each ported family (resnet, resnetd, danet, propainter_rfc,
    efficientnet, propainter, propainter_ip, wrn, seresnet, resnext,
    seresnext, senet, raft, mobilenet, mobilenetv2, mobilenetv3, pspnet,
    deeplabv3, fcn8sd, centernet, alphapose_coco, fastseresnet) registers
    exactly the JAX package's names of that family, and nothing else;
    simplepose_coco its four ResNet variants (the ResNet-A ones are not yet
    ported)."""
    def family(names, registry, fam):
        return {n for n in names if registry.get_constructor(
            n).__module__.rsplit(".", 1)[-1] == fam}
    port_names = set(pt.registered_models())
    from pytorchcv_tpu_torch.models import registry as port_registry
    counts = {}
    for fam in ("resnet", "resnetd", "danet", "propainter_rfc",
                "efficientnet", "propainter", "propainter_ip", "wrn",
                "seresnet", "resnext", "seresnext", "senet", "raft",
                "mobilenet", "mobilenetv2", "mobilenetv3", "pspnet",
                "deeplabv3", "fcn8sd", "centernet", "alphapose_coco",
                "fastseresnet"):
        jax_names = family(jax_registry.registered_models(), jax_registry,
                           fam)
        assert family(port_names, port_registry, fam) == jax_names, fam
        counts[fam] = len(jax_names)
    assert counts == {"resnet": 21, "resnetd": 3, "danet": 2,
                      "propainter_rfc": 1, "efficientnet": 26,
                      "propainter": 1, "propainter_ip": 1, "wrn": 1,
                      "seresnet": 17, "resnext": 10, "seresnext": 3,
                      "senet": 6, "raft": 2, "mobilenet": 12,
                      "mobilenetv2": 8, "mobilenetv3": 10, "pspnet": 8,
                      "deeplabv3": 10, "fcn8sd": 8, "centernet": 6,
                      "alphapose_coco": 1, "fastseresnet": 1}
    simplepose = family(port_names, port_registry, "simplepose_coco")
    assert simplepose == {n for n in family(
        jax_registry.registered_models(), jax_registry, "simplepose_coco")
        if "resneta" not in n}
    assert len(simplepose) == 4
    assert len(port_names) == 162


def test_get_model_is_seeded_and_named():
    a = pt.get_model("resnet18_wd4", rng=3, device="cpu")
    b = pt.get_model("resnet18_wd4", rng=3, device="cpu")
    c = pt.get_model("resnet18_wd4", rng=4, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    key = "features.stage1.unit1.body.conv1.conv.weight"
    assert torch.equal(sa[key], sb[key]) and not torch.equal(sa[key], sc[key])
    r50 = pt.get_model("resnet50", device="cpu").state_dict()
    for k in ("features.init_block.conv.conv.weight",
              "features.init_block.conv.bn.running_var",
              "features.stage2.unit1.identity_conv.conv.weight",
              "features.stage4.unit3.body.conv3.bn.weight", "output.weight"):
        assert k in r50, k
    assert tuple(r50["output.weight"].shape) == (1000, 2048)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        pt.get_model("resnet50", pretrained=True)


def test_serving_end_to_end_matches_reference_forward():
    serve = pt.make_serving_fn("resnet10", source_hw=(74, 74), device="cpu")
    raw = np.random.default_rng(0).integers(0, 256, (2, 74, 74, 3),
                                            dtype=np.uint8)
    logits = serve(raw)
    ref = serve.make_reference_forward()(raw)
    assert logits.shape == (2, 1000) and logits.dtype == torch.bfloat16
    y = logits.to(torch.float32)
    assert bool(torch.isfinite(y).all())
    cos = float(torch.nn.functional.cosine_similarity(
        y.flatten(), ref.flatten(), dim=0))
    assert cos >= 0.995, cos
    with pytest.raises(NotImplementedError):
        pt.make_serving_fn("resnet10", (74, 74), mode="fp16", device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, get_model, make_serving_fn and the ProPainter
    sequencers without a model raise unless the CPU is asked for; they
    never fall back to it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.get_model("resnet10")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.make_serving_fn("resnet10", (74, 74))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.make_serving_fn("danet_resnetd50b_cityscapes", (72, 96),
                           task="segmentation", device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.get_model("propainter_rfc")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProPainterRFCSequencer(torch.zeros(2, 4, 8, 8),
                               torch.zeros(3, 1, 8, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.get_model("propainter")
    frames, masks = torch.zeros(3, 3, 8, 8), torch.zeros(3, 1, 8, 8)
    flows = torch.zeros(2, 4, 8, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProPainterIPSequencer(frames, masks, flows)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProPainterITSequencer(torch.zeros(3, 4, 8, 8), masks, flows)
    ip = ProPainterIPSequencer(frames, masks, flows, device="cpu")
    assert ip.net.training is False and ip.device.type == "cpu"
    cpu_model = pt.get_model("resnet10", device="cpu")
    assert next(cpu_model.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.make_serving_fn("resnet10", (74, 74), model=cpu_model)
