"""pytorchcv_tpu_torch: the PyTorch/CUDA port of pytorchcv_tpu.

Models are NCHW ``nn.Module``s whose ``state_dict`` names are the reference
pytorchcv names; the int8 serving paths (ResNet classification, DANet
segmentation) and ProPainter's recurrent flow completion (streamed by
``streaming``) run on hand-written CUDA kernels for Hopper (``kernels/``,
sources in ``csrc/``), with plain PyTorch versions on CPU tensors. The entry
points run on the CUDA card unless the caller asks for the CPU. The package
imports torch and numpy only.
"""

__version__ = "0.1.0"

from .model_provider import get_model
from .models import registered_models
from .serve import make_serving_fn

__all__ = ["get_model", "make_serving_fn", "registered_models",
           "__version__"]
