"""The port's int8 MobileNet v1 and v2 pipelines against the JAX
package's (``quant/mobilenet_int8.py``) on the same weights and JAX's
scales at 64x64, map by map: the int8 map into every conv bit for bit
(where the stem differs, at most 0.1 % of its elements by 1, bit for bit
once the port is handed JAX's stem map), logits at cosine >= 0.9999 with
argmax agreement 1.0.

The JAX pipelines run op by op, as their code is written (``infer_fn``
un-jitted): under ``jax.jit`` XLA:CPU fuses ``acc * A + B`` into one
multiply-add where the result stays f32 (the projection's term before the
linear residual; and, at .5 boundaries, before a requant), so the jitted
pipeline differs from its own op-by-op run (``mobilenetv2_w3d4`` at 64x64:
one element of the 15th map, then up to 5 % of the elements of later maps,
logits cosine 0.99939). The port, like K2 since its first slice, rounds
each step as written. The op-by-op runs compile each op on its own: ~40 s
for the four pipelines here; ``test_torch_port_mobilenet_pad.py`` runs
the fifth, ``mobilenetv2_w3d4``'s padded channels, through
:func:`check_pipeline` (~17 s), so that each file stays under a minute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pytorchcv_tpu.quant.mobilenet_int8 as jmi
from pytorchcv_tpu.quant import calibrate_int8 as jax_calibrate
from pytorchcv_tpu.quant.mobilenet_int8 import _conv_i8
import pytorchcv_tpu_torch.quant.mobilenet_int8 as tmi
from pytorchcv_tpu_torch.kernels.dwconv_i8 import dwconv_i8
from pytorchcv_tpu_torch.kernels.int8_conv import int8_conv
from pytorchcv_tpu_torch.quant import (is_mobilenet_v1_tree,
                                       is_mobilenet_v2_tree)
from test_torch_port_mobilenet import _SIZE, _cosine, _nchw, _pair

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["mobilenetv2_wd2", "mobilenetv2b_wd2",
                                  "mobilenet_wd2", "fdmobilenet_wd2"])
def test_int8_pipeline_matches_jax(name, monkeypatch):
    check_pipeline(name, monkeypatch)


def check_pipeline(name, monkeypatch):
    """``prepare_int8_mobilenet`` / ``_v1`` against the JAX package's on the
    same weights and JAX's scales at 64x64: the int8 map into every conv
    (``_conv_i8``'s input; in the port K2's and K12's, the padded channels
    of ``mobilenetv2_w3d4`` cut off) bit for bit, where the stem differs
    (at most 0.1 % of its elements, by 1) bit for bit once the port is
    handed JAX's stem map; logits at cosine >= 0.9999, argmax agreement
    1.0. Measured when written: every map bit-exact, stem included."""
    jm, tm = _pair(name)
    rng = np.random.default_rng(5)
    xc = rng.standard_normal((4, *_SIZE, 3)).astype(np.float32)
    scales = jax_calibrate(jm, [jnp.asarray(xc)])
    v1 = name.startswith(("mobilenet_", "fdmobilenet_"))
    assert (is_mobilenet_v1_tree if v1 else is_mobilenet_v2_tree)(tm)
    jprep = jmi.prepare_int8_mobilenet_v1 if v1 else \
        jmi.prepare_int8_mobilenet
    tprep = tmi.prepare_int8_mobilenet_v1 if v1 else \
        tmi.prepare_int8_mobilenet
    xb = jnp.asarray(rng.standard_normal((2, *_SIZE, 3)), jnp.bfloat16)
    want_maps = []
    monkeypatch.setattr(jmi, "_conv_i8", lambda xq, wq, s: (
        want_maps.append(np.asarray(xq)), _conv_i8(xq, wq, s))[1])
    fn, qtree = jprep(jm, scales)
    want = np.asarray(fn(qtree, xb).astype(jnp.float32))
    monkeypatch.undo()

    run, plan = tprep(tm, scales)
    xt = _nchw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)

    def port(stem_map=None):
        maps = []

        def rec(kernel):
            def wrapped(x, *a, **k):
                maps.append(x.numpy()[..., :want_maps[len(maps)].shape[-1]])
                return kernel(x, *a, **k)
            return wrapped
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmi, "int8_conv", rec(int8_conv))
            mp.setattr(tmi, "dwconv_i8", rec(dwconv_i8))
            if stem_map is not None:
                mp.setattr(tmi, "stem_conv", lambda *a, **k:
                           torch.from_numpy(stem_map))
            with torch.inference_mode():
                logits = run(plan, xt).float().numpy()
        return maps, logits

    maps, got = port()
    assert len(maps) == len(want_maps)
    stem_diff = np.abs(maps[0].astype(np.int32) - want_maps[0])
    assert stem_diff.max() <= 1 and (stem_diff != 0).mean() <= 1e-3
    if stem_diff.any():
        maps, _ = port(want_maps[0])
    exact = [np.array_equal(m, w) for m, w in zip(maps, want_maps)]
    print(f"{name}: {sum(exact)} of {len(exact)} maps bit-exact, stem "
          f"{(stem_diff == 0).mean():.6f} of its elements")
    assert all(exact), exact
    assert _cosine(got, want) >= 0.9999, _cosine(got, want)
    assert (got.argmax(1) == want.argmax(1)).all()
