"""``inference``: the deployment facade (counterpart of
``paddle_tpu/inference/__init__.py``).

Reference analog: AnalysisPredictor + AnalysisConfig
(paddle/fluid/inference/api/analysis_predictor.h,
paddle_inference_api.h). The predictor is a ``jit.save`` artifact loaded
by ``jit.load``: the recorded aten ops and the kernels' custom ops, run
on the card (``Config.enable_use_gpu``, the default) or on the CPU
(``Config.disable_gpu``). The reference's analysis passes (IR fusion,
TensorRT subgraphs, memory reuse) have no counterpart here: those knobs
are recorded, have no effect, and warn.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import jit as _jit
from ..static import _to_numpy

__all__ = ["Config", "Predictor", "create_predictor", "PredictorTensor",
           "BatchingEngine"]

from .serving import BatchingEngine  # noqa: E402,F401


class Config:
    """Reference: AnalysisConfig (inference/api/analysis_config.cc). The
    device is the card unless ``disable_gpu()`` asks for the CPU."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        # paddle convention: prog_file like /p/model.pdmodel
        if prog_file and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[: -len(".pdmodel")]
        self._prefix = prog_file
        self._memory_pool_mb = 0
        self._device: Optional[str] = None     # None: the card
        self._flags: Dict[str, object] = {}

    def set_prog_file(self, p):
        if p and p.endswith(".pdmodel"):
            p = p[: -len(".pdmodel")]
        self._prefix = p

    def prog_file(self):
        return (self._prefix or "") + ".pdmodel"

    # TensorRT/IR/memory knobs: recorded, without effect here. Accepting
    # them SILENTLY would be a usability trap (a user porting a reference
    # deployment would believe TensorRT kicked in): each warns.
    def _inert(self, knob, detail):
        import warnings
        warnings.warn(
            f"inference.Config.{knob} has no effect in paddle_tpu_torch "
            f"({detail}); the setting is recorded but ignored",
            UserWarning, stacklevel=3)

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        """Run on card ``device_id`` (the default is card 0)."""
        self._memory_pool_mb = memory_pool_init_size_mb
        self._device = f"cuda:{int(device_id)}"
        self._flags["use_gpu"] = True

    def disable_gpu(self):
        """Run on the CPU."""
        self._device = "cpu"
        self._flags["use_gpu"] = False

    def enable_tensorrt_engine(self, **kwargs):
        self._inert("enable_tensorrt_engine",
                    "the program runs as exported, its kernels hand-written")
        self._flags["tensorrt"] = kwargs

    def switch_ir_optim(self, enable=True):
        self._inert("switch_ir_optim", "no IR passes run on the program")
        self._flags["ir_optim"] = enable

    def enable_memory_optim(self):
        self._inert("enable_memory_optim",
                    "PyTorch's caching allocator plans the memory")
        self._flags["memory_optim"] = True


class PredictorTensor:
    """Zero-copy-style input/output handle (reference ZeroCopyTensor)."""

    def __init__(self, name):
        self.name = name
        self._value = None
        self._shape = None

    def copy_from_cpu(self, arr):
        arr = np.asarray(arr)
        self._value = arr.reshape(self._shape) if self._shape is not None \
            else arr

    def copy_to_cpu(self):
        return np.asarray(self._value)

    def reshape(self, shape):
        """The shape the next ``copy_from_cpu`` takes (the artifact's
        ``None`` dimensions accept any size)."""
        self._shape = tuple(int(d) for d in shape)


class Predictor:
    """Reference: AnalysisPredictor::Run. Wraps a ``jit.load`` artifact on
    the Config's device."""

    def __init__(self, config: Config):
        if not config._prefix:
            raise ValueError("Config needs the model path prefix")
        self._layer = _jit.load(config._prefix, device=config._device)
        self._input_names = self._layer.input_names
        self._inputs: Dict[str, PredictorTensor] = {
            n: PredictorTensor(n) for n in self._input_names}
        self._outputs: List[np.ndarray] = []

    @property
    def device(self) -> torch.device:
        return self._layer.device

    def get_input_names(self):
        return list(self._input_names)

    def get_input_handle(self, name) -> PredictorTensor:
        return self._inputs[name]

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """Run the program on ``inputs`` (arrays, in the order of the
        input names), or on what the input handles hold; returns the
        outputs as numpy arrays (bfloat16 ones as float32)."""
        if inputs is None:
            unset = [n for n in self._input_names
                     if self._inputs[n]._value is None]
            if unset:
                raise ValueError(
                    f"input(s) {unset} were never set: call "
                    f"get_input_handle(name).copy_from_cpu(arr) first")
            inputs = [self._inputs[n].copy_to_cpu()
                      for n in self._input_names]
        out = self._layer(*inputs)
        flat = out if isinstance(out, (list, tuple)) else [out]
        self._outputs = [_to_numpy(o) for o in flat]
        return self._outputs

    def get_output_names(self):
        return [f"output_{i}" for i in range(len(self._outputs))]

    def get_output_handle(self, name) -> PredictorTensor:
        idx = int(name.split("_")[-1])
        t = PredictorTensor(name)
        t._value = self._outputs[idx]
        return t


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
