"""Deployment artifacts: ONNX graphs (f32, fp16-stored, static int8 QDQ)
written and evaluated in-tree, their CoreML (MIL) mapping, and
``torch.export`` programs."""
from .export import (  # noqa: F401
    export_code_decoder,
    export_detector,
    export_transformer_decoder,
    export_transformer_encoder,
    load_exported,
    save_exported,
)
