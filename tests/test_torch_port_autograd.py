"""Calls that autograd records, and the f32 pin of ``get_model``'s forwards.

The hand kernels have no backward: their wrappers refuse a call that
autograd would record, on the CPU as on the card, and the models route
such calls to the plain versions, which differentiate. So DANet's position
attention, the deformable alignment and ProPainter's window attention give
gradients on every device. A model from ``get_model`` runs its forward
under ``no_tf32()`` and restores torch's TF32 flags after it.
"""

import numpy as np
import pytest
import torch

import pytorchcv_tpu_torch as pt
from pytorchcv_tpu_torch.kernels import LAUNCHES
from pytorchcv_tpu_torch.kernels.deform_patch import deform_sample
from pytorchcv_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_reference)
from pytorchcv_tpu_torch.models.danet import PosAttBlock
from pytorchcv_tpu_torch.nn.deform import deform_conv2d

torch.set_num_threads(1)


def _deform_inputs(seed, h=16, w=18, c=8, g=2, rb=2.0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, c, h, w)).astype(np.float32))
    offset = torch.from_numpy(rng.uniform(-rb, rb, (1, 18 * g, h, w))
                              .astype(np.float32))
    mask = torch.from_numpy(rng.random((1, 9 * g, h, w)).astype(np.float32))
    return x, offset, mask


@pytest.mark.parametrize("wrapper", ["flash_attention", "deform_sample"])
def test_wrappers_refuse_recorded_calls(wrapper):
    if wrapper == "flash_attention":
        q = torch.randn(1, 12, 8)
        call = lambda t: flash_attention(t, q, q)            # noqa: E731
    else:
        x, offset, mask = _deform_inputs(0)
        call = lambda t: deform_sample(t, offset, mask, 2, 2.0)  # noqa: E731
        q = x
    call(q)                                  # unrecorded: the plain version
    with pytest.raises(ValueError, match="no backward"):
        call(q.clone().requires_grad_(True))
    with torch.no_grad():
        call(q.clone().requires_grad_(True))


def test_position_attention_backward():
    """PosAttBlock takes the plain attention when autograd records: the
    query, key and value convs get the gradients of the dense formula."""
    torch.manual_seed(0)
    block = PosAttBlock(16)
    with torch.no_grad():
        block.scale.alpha.fill_(0.7)
    x = torch.randn(2, 16, 5, 6, requires_grad=True)
    block(x).square().sum().backward()
    grads = [m.weight.grad.clone() for m in
             (block.query_conv, block.key_conv, block.value_conv)]
    assert all(g is not None and float(g.abs().max()) > 0 for g in grads)
    # the same formula written out
    for m in (block.query_conv, block.key_conv, block.value_conv):
        m.weight.grad = None

    def tokens(t):
        return t.flatten(2).transpose(1, 2)
    y = flash_attention_reference(tokens(block.query_conv(x)),
                                  tokens(block.key_conv(x)),
                                  tokens(block.value_conv(x)))
    y = 0.7 * y.transpose(1, 2).reshape(x.shape) + x
    y.square().sum().backward()
    for g, m in zip(grads, (block.query_conv, block.key_conv,
                            block.value_conv)):
        torch.testing.assert_close(g, m.weight.grad)


def test_deform_conv2d_backward_on_the_k5_contract():
    """A call inside K5's contract takes the general route when autograd
    records it, and the offsets get gradients."""
    x, offset, mask = _deform_inputs(1)
    offset.requires_grad_(True)
    wgt = torch.randn(4, 8, 3, 3) * 0.1
    kw = dict(deform_groups=2, center=torch.zeros(1, 2, 16, 18),
              residue_bound=2.0)
    out = deform_conv2d(x, offset, mask, wgt, **kw)
    out.square().sum().backward()
    assert offset.grad is not None and float(offset.grad.abs().max()) > 0
    with torch.no_grad():
        torch.testing.assert_close(deform_conv2d(x, offset, mask, wgt, **kw),
                                   out)


def test_generator_backward_reaches_attention_linears():
    """A tiny ProPainter generator (hidden 128, depth 2) differentiates on
    the CPU with grad mode on: the window attention's linears and the
    deformable alignment's offset conv get gradients."""
    model = pt.get_model("propainter", device="cpu", hidden_dim=128, depth=2,
                         in_size=(48, 80))
    rng = np.random.default_rng(2)
    t, l_t, (h, w) = 3, 2, (48, 80)
    frames = torch.from_numpy(rng.uniform(-1, 1, (1, t, 3, h, w))
                              .astype(np.float32))
    masks = torch.zeros(1, t, 1, h, w)
    masks[..., 10:30, 20:50] = 1.0
    flows = torch.from_numpy(rng.uniform(-1, 1, (1, l_t - 1, 4, h, w))
                             .astype(np.float32))
    before = dict(LAUNCHES)
    out = model(frames * (1 - masks), masks, masks, flows, l_t)
    out.square().mean().backward()
    assert dict(LAUNCHES) == before          # no kernel on the CPU
    attn = model.transformers.transformer[0].attention
    for lin in (attn.query, attn.key, attn.value, attn.proj):
        assert lin.weight.grad is not None, lin
        assert float(lin.weight.grad.abs().max()) > 0
    offsets = [p for n, p in model.feat_prop_module.named_parameters()
               if "conv_offset" in n and n.endswith("weight")]
    assert offsets and all(p.grad is not None for p in offsets)


def test_model_forward_pins_f32_and_restores_flags():
    model = pt.get_model("resnet10", in_size=(32, 32), device="cpu")
    seen = []
    model.features.stage1.register_forward_hook(lambda *_: seen.append(
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32)))
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with torch.no_grad():
            model(torch.zeros(1, 3, 32, 32))
        assert seen == [(False, False)]
        assert torch.backends.cudnn.allow_tf32 and \
            torch.backends.cuda.matmul.allow_tf32
        with pytest.raises(RuntimeError):       # 5 channels: the stem raises
            model(torch.zeros(1, 5, 32, 32))
        assert torch.backends.cudnn.allow_tf32 and \
            torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = old
