"""``onnx`` (counterpart of ``paddle_tpu/onnx/__init__.py``; reference:
python/paddle/onnx/export.py, a shim over the external paddle2onnx).

The inference graph comes from the static-capture recorder and the
ModelProto is written by the protobuf writer in ``proto.py``: a real
exporter with no onnx package, covering the vision-zoo/MLP inference op
set. An unsupported op raises ``OnnxExportError`` naming it, the
paddle2onnx unsupported-op analog. For serving on the card, ``jit.save``
(a ``torch.export`` artifact) stays the native path.
"""
from .export import OnnxExportError, export  # noqa: F401

__all__ = ["export", "OnnxExportError"]
