"""Minimal ONNX protobuf WRITER, no ``onnx`` package needed (a copy of
``paddle_tpu/onnx/proto.py``, which imports nothing of JAX: the port
imports nothing of the JAX package).

Reference analog: paddle2onnx's use of the onnx python bindings. The
ModelProto wire format is emitted directly: varints, tags,
length-delimited submessages. Field numbers follow the stable
onnx.proto3 schema (ir_version 8 era).

Only the message subset an inference graph needs is implemented:
ModelProto / GraphProto / NodeProto / TensorProto / ValueInfoProto /
AttributeProto / OperatorSetIdProto.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

__all__ = ["TensorProto", "ValueInfo", "Node", "Graph", "Model",
           "DTYPE_MAP"]

# onnx TensorProto.DataType values
DTYPE_MAP = {
    "float32": 1, "uint8": 2, "int8": 3, "uint16": 4, "int16": 5,
    "int32": 6, "int64": 7, "bool": 9, "float16": 10, "float64": 11,
    "uint32": 12, "uint64": 13, "bfloat16": 16,
}


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(int(value))


def _f_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _f_string(field: int, value: str) -> bytes:
    return _f_bytes(field, value.encode("utf-8"))


def _f_repeated_varint_packed(field: int, values: Iterable[int]) -> bytes:
    payload = b"".join(_varint(int(v)) for v in values)
    return _f_bytes(field, payload)


def _f_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(value))


class TensorProto:
    """onnx.TensorProto: dims=1, data_type=2, name=8, raw_data=9."""

    def __init__(self, name: str, array: np.ndarray):
        self.name = name
        self.array = np.ascontiguousarray(array)

    def dtype_code(self) -> int:
        key = str(self.array.dtype)
        if key not in DTYPE_MAP:
            raise ValueError(f"dtype {key} has no ONNX mapping")
        return DTYPE_MAP[key]

    def encode(self) -> bytes:
        return b"".join([_f_varint(1, d) for d in self.array.shape] + [
            _f_varint(2, self.dtype_code()), _f_string(8, self.name),
            _f_bytes(9, self.array.tobytes())])


class ValueInfo:
    """onnx.ValueInfoProto: name=1, type=2 (TypeProto.tensor_type=1 with
    elem_type=1 and shape=2; TensorShapeProto.dim=1 with dim_value=1 /
    dim_param=2)."""

    def __init__(self, name: str, dtype: str,
                 shape: Sequence[Union[int, str, None]]):
        self.name = name
        self.dtype = dtype
        self.shape = list(shape)

    def encode(self) -> bytes:
        dims = b""
        for d in self.shape:
            if isinstance(d, int) and d >= 0:
                dim = _f_varint(1, d)
            else:  # symbolic / batch dim
                dim = _f_string(2, str(d) if d not in (None, -1)
                                else "batch")
            dims += _f_bytes(1, dim)
        tensor_type = (_f_varint(1, DTYPE_MAP[self.dtype])
                       + _f_bytes(2, dims))
        type_proto = _f_bytes(1, tensor_type)
        return _f_string(1, self.name) + _f_bytes(2, type_proto)


def _attr(name: str, value) -> bytes:
    """onnx.AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
    type=20 (FLOAT=1 INT=2 STRING=3 TENSOR=4 FLOATS=6 INTS=7)."""
    out = _f_string(1, name)
    if isinstance(value, bool):
        out += _f_varint(3, int(value)) + _f_varint(20, 2)
    elif isinstance(value, int):
        out += _f_varint(3, value) + _f_varint(20, 2)
    elif isinstance(value, float):
        out += _f_float(2, value) + _f_varint(20, 1)
    elif isinstance(value, str):
        out += _f_bytes(4, value.encode()) + _f_varint(20, 3)
    elif isinstance(value, TensorProto):
        out += _f_bytes(5, value.encode()) + _f_varint(20, 4)
    elif isinstance(value, (list, tuple)) and value and \
            all(isinstance(v, float) for v in value):
        for v in value:
            out += _f_float(7, v)
        out += _f_varint(20, 6)
    elif isinstance(value, (list, tuple)):
        for v in value:
            out += _f_varint(8, int(v))
        out += _f_varint(20, 7)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return out


class Node:
    """onnx.NodeProto: input=1, output=2, name=3, op_type=4,
    attribute=5."""

    def __init__(self, op_type: str, inputs: Sequence[str],
                 outputs: Sequence[str], name: str = "",
                 attrs: Optional[dict] = None):
        self.op_type = op_type
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.name = name
        self.attrs = attrs or {}

    def encode(self) -> bytes:
        out = b""
        for i in self.inputs:
            out += _f_string(1, i)
        for o in self.outputs:
            out += _f_string(2, o)
        if self.name:
            out += _f_string(3, self.name)
        out += _f_string(4, self.op_type)
        for k in sorted(self.attrs):
            out += _f_bytes(5, _attr(k, self.attrs[k]))
        return out


class Graph:
    """onnx.GraphProto: node=1, name=2, initializer=5, input=11,
    output=12."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: List[Node] = []
        self.initializers: List[TensorProto] = []
        self.inputs: List[ValueInfo] = []
        self.outputs: List[ValueInfo] = []

    def encode(self) -> bytes:
        # one join: the initializers hold a model's weights (100 MB for
        # ResNet-50), which repeated concatenation would copy again and
        # again
        out = [_f_bytes(1, n.encode()) for n in self.nodes]
        out.append(_f_string(2, self.name))
        out += [_f_bytes(5, t.encode()) for t in self.initializers]
        out += [_f_bytes(11, v.encode()) for v in self.inputs]
        out += [_f_bytes(12, v.encode()) for v in self.outputs]
        return b"".join(out)


class Model:
    """onnx.ModelProto: ir_version=1, producer_name=2, producer_version=3,
    graph=7, opset_import=8 (OperatorSetIdProto: domain=1, version=2)."""

    def __init__(self, graph: Graph, opset: int = 13,
                 producer: str = "paddle-tpu", ir_version: int = 8):
        self.graph = graph
        self.opset = opset
        self.producer = producer
        self.ir_version = ir_version

    def encode(self) -> bytes:
        opset = _f_string(1, "") + _f_varint(2, self.opset)
        return (_f_varint(1, self.ir_version)
                + _f_string(2, self.producer)
                + _f_string(3, "0")
                + _f_bytes(7, self.graph.encode())
                + _f_bytes(8, opset))
