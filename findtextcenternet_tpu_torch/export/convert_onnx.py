"""CLI: convert trained models to ONNX (and the reference's other
deployment targets) through the reference-checkpoint bridge.

Counterpart of ``findtextcenternet_tpu/export/convert_onnx.py``. For the
reference's mobile targets (ONNX + int8 QDQ, CoreML mlprogram) one path
is: write reference-format ``model.pt``/``model3.pt`` from the port's
training checkpoints (step 1, :func:`..io.torch_export.
export_torch_checkpoints`), then run the reference's own converters
(``convert1_onnx.py``, ``convert3_onnx.py``, ``quantize1_onnx.py``,
``convert1_coreml.py``, ``convert3_coreml.py``) unchanged (step 2). The
in-tree writers (:mod:`.onnx_models`, :mod:`.coreml_models`) need neither
step 2 nor the ``onnx`` package.

Step 2 needs the ``onnx`` package and a checkout of the reference; the
script stops after step 1 with instructions when ``onnx`` is missing.

Usage:
    python -m findtextcenternet_tpu_torch.export.convert_onnx \\
        --detector-ckpt=result1 --transformer-ckpt=result3 \\
        --out=exported_onnx [--reference=/path/to/findtextCenterNet]
"""
from __future__ import annotations

import os
import subprocess
import sys

from ..io.torch_export import export_torch_checkpoints


def run_reference_converters(out_dir: str, reference: str) -> int:
    """Step 2: drive the reference's converters on the exported .pt."""
    try:
        import onnx  # noqa: F401
    except ImportError:
        print("onnx is not installed; stopping after the .pt export.\n"
              "To finish: pip install onnx onnxruntime, then run\n"
              f"  cd {reference} && python convert1_onnx.py && "
              "python convert3_onnx.py\n"
              f"with the exported checkpoints from {out_dir} placed in "
              "the reference root.", file=sys.stderr)
        return 1
    rc = 0
    for script in ("convert1_onnx.py", "convert3_onnx.py"):
        path = os.path.join(reference, script)
        if not os.path.exists(path):
            print(f"missing {path}", file=sys.stderr)
            rc = 1
            continue
        r = subprocess.run([sys.executable, script], cwd=reference)
        rc = rc or r.returncode
    return rc


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    out = "exported_onnx"
    det_ckpt = tf_ckpt = reference = None
    for a in argv:
        if a.startswith("--out="):
            out = a.split("=", 1)[1]
        elif a.startswith("--detector-ckpt="):
            det_ckpt = a.split("=", 1)[1]
        elif a.startswith("--transformer-ckpt="):
            tf_ckpt = a.split("=", 1)[1]
        elif a.startswith("--reference="):
            reference = a.split("=", 1)[1]
    written = export_torch_checkpoints(out, det_ckpt, tf_ckpt)
    for path in written.values():
        print(f"wrote {path}")
    if reference:
        return run_reference_converters(out, reference)
    return 0


if __name__ == "__main__":
    sys.exit(main())
