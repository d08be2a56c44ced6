"""findtextcenternet_tpu_torch: the PyTorch + CUDA port of findtextcenternet_tpu.

Page OCR serving (EfficientNetV2 CenterNet detector, native line engine,
mask-predict Transformer) and the three training stages (the detector,
``train1``/``train2``; the Transformer, ``train3``) on an NVIDIA Hopper
GPU, with hand-written CUDA kernels in place of the JAX package's Pallas
kernels (``csrc/``). The JAX package stays the reference; this package
imports nothing from it.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from . import const  # noqa: F401
from .config import Config  # noqa: F401
