"""``onnx.export`` in the port against the JAX package's exporter, on the
CPU. Both write the ModelProto with their own protobuf writer; these
tests decode the bytes with an independent wire-format reader (the JAX
suite's, ``tests/test_onnx_export.py``) and compare.

Exact, from the same weights (``convert.layer_from_jax``): the graph of
an MLP (Linear, GELU, LayerNorm, softmax) and of a small conv/BN/pool
net, node by node (op type, attributes, wiring up to the value names,
which each exporter makes its own), and every initializer bit-equal
(parameters in the JAX layout: the port's ``[out, in]`` ``Linear``
weight is written ``[in, out]``; BatchNorm's statistics; the shape and
scalar constants). The JAX suite's structure and error cases hold for
the port as they are.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import layer_from_jax
from paddle_tpu_torch.onnx import OnnxExportError
from paddle_tpu_torch.static import InputSpec


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


# -- minimal reader (independent of the writers' code paths) -----------------

def _read_varint(buf, i):
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf):
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wire == 5:
            val = buf[i:i + 4]
            i += 4
        else:
            raise AssertionError(f"wire {wire}")
        yield field, val


def _parse_model(data):
    model = {"opsets": []}
    for f, v in _fields(data):
        if f == 1:
            model["ir_version"] = v
        elif f == 2:
            model["producer"] = v.decode()
        elif f == 7:
            model["graph"] = v
        elif f == 8:
            model["opsets"].append(
                {"version": x for ff, x in _fields(v) if ff == 2})
    return model


def _parse_graph(data):
    g = {"nodes": [], "initializers": [], "inputs": [], "outputs": []}
    for f, v in _fields(data):
        if f == 1:
            g["nodes"].append(_parse_node(v))
        elif f == 5:
            g["initializers"].append(_parse_tensor(v))
        elif f == 11:
            g["inputs"].append(_parse_value_info(v))
        elif f == 12:
            g["outputs"].append(_parse_value_info(v))
    return g


def _parse_node(data):
    n = {"inputs": [], "outputs": [], "op_type": None, "attrs": {}}
    for f, v in _fields(data):
        if f == 1:
            n["inputs"].append(v.decode())
        elif f == 2:
            n["outputs"].append(v.decode())
        elif f == 4:
            n["op_type"] = v.decode()
        elif f == 5:
            name, val = _parse_attr(v)
            n["attrs"][name] = val
    return n


def _parse_attr(data):
    name, val, ints, floats = None, None, [], []
    for f, v in _fields(data):
        if f == 1:
            name = v.decode()
        elif f == 2:
            val = float(np.frombuffer(v, "<f4")[0])
        elif f == 3:
            val = v
        elif f == 7:
            floats.append(float(np.frombuffer(v, "<f4")[0]))
        elif f == 8:
            ints.append(v)
    return name, (ints or floats or val)


def _parse_tensor(data):
    t = {"dims": [], "name": None, "raw": None, "dtype": None}
    for f, v in _fields(data):
        if f == 1:
            t["dims"].append(v)
        elif f == 2:
            t["dtype"] = v
        elif f == 8:
            t["name"] = v.decode()
        elif f == 9:
            t["raw"] = bytes(v)
    return t


def _parse_value_info(data):
    for f, v in _fields(data):
        if f == 1:
            return v.decode()
    return None


def _export_and_parse(export, layer, spec, path):
    out = export(layer, str(path), input_spec=spec)
    model = _parse_model(open(out, "rb").read())
    return model, _parse_graph(model["graph"])


def _canonical(graph):
    """The graph with every value renamed by its first appearance (the
    inputs, the initializers in order, then each node's inputs and
    outputs): op types, attributes, wiring and initializer payloads,
    free of either exporter's naming."""
    names = {}

    def canon(n):
        return names.setdefault(n, f"v{len(names)}")

    for n in graph["inputs"]:
        canon(n)
    inits = [(canon(t["name"]), tuple(t["dims"]), t["dtype"], t["raw"])
             for t in graph["initializers"]]
    nodes = [(n["op_type"], sorted(n["attrs"].items()),
              [canon(i) for i in n["inputs"]],
              [canon(o) for o in n["outputs"]]) for n in graph["nodes"]]
    outs = [canon(o) for o in graph["outputs"]]
    return nodes, inits, outs


def _nets(kind):
    """The same network in both packages, the port's weights carried
    from the JAX one."""
    def mlp(nn):
        return nn.Sequential(nn.Linear(8, 16), nn.GELU(), nn.LayerNorm(16),
                             nn.Linear(16, 4), nn.Softmax())

    def conv(nn):
        return nn.Sequential(nn.Conv2D(3, 4, 3, padding=1),
                             nn.BatchNorm2D(4), nn.ReLU(),
                             nn.MaxPool2D(2), nn.AvgPool2D(2),
                             nn.Conv2D(4, 6, 1), nn.AdaptiveAvgPool2D(1),
                             nn.Flatten(), nn.Linear(6, 3))

    make = {"mlp": mlp, "conv": conv}[kind]
    paddle.seed(11)
    jnet = make(paddle.nn)
    if kind == "conv":
        # non-trivial BatchNorm statistics, the same in both
        rng = np.random.RandomState(12)
        import jax.numpy as jnp
        jnet[1]._mean._data = jnp.asarray(rng.randn(4).astype("float32"))
        jnet[1]._variance._data = jnp.asarray(
            rng.rand(4).astype("float32") + 0.5)
    tnet = make(pt.nn)
    layer_from_jax(tnet, {k: np.asarray(v.numpy())
                          for k, v in jnet.state_dict().items()})
    return jnet, tnet


@pytest.mark.parametrize("kind,shape", [("mlp", [None, 8]),
                                        ("conv", [None, 3, 8, 8])])
def test_graph_node_by_node_and_initializers_bit_equal(kind, shape,
                                                       tmp_path):
    jnet, tnet = _nets(kind)
    _, jgraph = _export_and_parse(paddle.onnx.export, jnet,
                                  [paddle.static.InputSpec(shape,
                                                           "float32")],
                                  tmp_path / "jax")
    model, tgraph = _export_and_parse(pt.onnx.export, tnet,
                                      [InputSpec(shape, "float32")],
                                      tmp_path / "port")
    jnodes, jinits, jouts = _canonical(jgraph)
    tnodes, tinits, touts = _canonical(tgraph)
    assert [n[0] for n in tnodes] == [n[0] for n in jnodes]
    for t, j in zip(tnodes, jnodes):
        assert t == j, (t, j)
    assert len(tinits) == len(jinits)
    for t, j in zip(tinits, jinits):
        assert t == j, (t[:3], j[:3])
    assert touts == jouts
    assert tgraph["inputs"] == jgraph["inputs"] == ["x0"]
    assert model["producer"] == "paddle-tpu-torch"
    assert model["opsets"][0]["version"] == 17


def test_lenet_structure_and_initializers_are_the_parameters(tmp_path):
    from paddle_tpu_torch.vision.models import LeNet
    net = LeNet()
    _, graph = _export_and_parse(pt.onnx.export, net,
                                 [InputSpec([None, 1, 28, 28], "float32")],
                                 tmp_path / "lenet")
    ops = [n["op_type"] for n in graph["nodes"]]
    assert "Conv" in ops and "MaxPool" in ops and "Relu" in ops
    assert "MatMul" in ops and "Transpose" not in ops
    assert graph["inputs"] == ["x0"] and len(graph["outputs"]) == 1
    known = set(graph["inputs"]) | {t["name"]
                                    for t in graph["initializers"]}
    for n in graph["nodes"]:
        for i in n["inputs"]:
            assert i in known, f"dangling input {i} of {n['op_type']}"
        known.update(n["outputs"])
    assert set(graph["outputs"]) <= known
    inits = {t["name"]: t for t in graph["initializers"]}
    linear = {f"{n}.weight" for n, m in net.named_modules()
              if isinstance(m, pt.nn.Linear)}
    assert len(linear) == 3
    for name, p in net.named_parameters():
        t = inits[name]
        arr = np.frombuffer(t["raw"], np.float32).reshape(t["dims"])
        want = p.detach().numpy()
        np.testing.assert_array_equal(arr, want.T if name in linear
                                      else want)


def test_resnet18_structure(tmp_path):
    from paddle_tpu_torch.vision.models import resnet18
    net = resnet18(num_classes=10)
    _, graph = _export_and_parse(pt.onnx.export, net,
                                 [InputSpec([None, 3, 32, 32], "float32")],
                                 tmp_path / "r18")
    ops = [n["op_type"] for n in graph["nodes"]]
    assert ops.count("Conv") == 20  # resnet18: 17 trunk + 3 downsample
    assert ops.count("Add") == 8 + 1  # residual adds, the head's bias
    assert "BatchNormalization" in ops and "GlobalAveragePool" in ops
    bn = next(n for n in graph["nodes"]
              if n["op_type"] == "BatchNormalization")
    assert len(bn["inputs"]) == 5 and len(bn["outputs"]) == 1


def test_unsupported_op_named(tmp_path):
    class Odd(pt.nn.Layer):
        def forward(self, x):
            return pt.cumsum(x, axis=1)

    with pytest.raises(OnnxExportError, match="cumsum"):
        pt.onnx.export(Odd(), str(tmp_path / "odd"),
                       input_spec=[InputSpec([None, 4], "float32")])

    class Sliced(pt.nn.Layer):
        def forward(self, x):
            return x[:, :2] * 2.0

    with pytest.raises(OnnxExportError, match="__getitem__"):
        pt.onnx.export(Sliced(), str(tmp_path / "sl"),
                       input_spec=[InputSpec([None, 4], "float32")])


def test_missing_spec_rejected(tmp_path):
    with pytest.raises(ValueError):
        pt.onnx.export(pt.nn.Linear(2, 2), str(tmp_path / "l"))


def test_flatten_start_axis_2_rejected(tmp_path):
    class F2(pt.nn.Layer):
        def forward(self, x):
            return pt.flatten(x, start_axis=2)

    with pytest.raises(OnnxExportError, match="start_axis"):
        pt.onnx.export(F2(), str(tmp_path / "f2"),
                       input_spec=[InputSpec([None, 2, 3, 4], "float32")])


def test_reshape_leading_batch_becomes_zero(tmp_path):
    class R(pt.nn.Layer):
        def forward(self, x):
            return pt.reshape(x, [1, 2, 6])

    _, graph = _export_and_parse(pt.onnx.export, R(),
                                 [InputSpec([None, 3, 4], "float32")],
                                 tmp_path / "rs")
    shape_init = next(t for t in graph["initializers"]
                      if t["name"].startswith("shape"))
    assert np.frombuffer(shape_init["raw"], np.int64)[0] == 0


def test_matmul_transpose_perm_swaps_last_two(tmp_path):
    class MM(pt.nn.Layer):
        def forward(self, x):
            return pt.matmul(x, x, transpose_y=True)

    _, graph = _export_and_parse(pt.onnx.export, MM(),
                                 [InputSpec([None, 5, 4, 6], "float32")],
                                 tmp_path / "mm")
    tr = next(n for n in graph["nodes"] if n["op_type"] == "Transpose")
    assert tr["attrs"]["perm"] == [0, 1, 3, 2]


def test_non_leading_dynamic_dim_rejected(tmp_path):
    with pytest.raises(OnnxExportError, match="leading"):
        pt.onnx.export(pt.nn.Linear(8, 2), str(tmp_path / "dyn"),
                       input_spec=[InputSpec([None, None, 8], "float32")])


def test_scale_bias_before_scale_order(tmp_path):
    class S(pt.nn.Layer):
        def forward(self, x):
            return pt.scale(x, scale=2.0, bias=3.0, bias_after_scale=False)

    _, graph = _export_and_parse(pt.onnx.export, S(),
                                 [InputSpec([None, 4], "float32")],
                                 tmp_path / "sc")
    ops = [n["op_type"] for n in graph["nodes"]]
    assert ops.index("Add") < ops.index("Mul")  # (x + b) * s


def test_torch_operators_map_and_a_stored_weight_transposes(tmp_path):
    """The recorder's torch-function nodes: ``x * 2.0 + y`` becomes Mul
    and Add with the scalar as a constant, and a ``Linear`` weight read
    as stored (``[out, in]``) goes through a Transpose of its
    ``[in, out]`` initializer."""
    class T(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pt.nn.Linear(4, 3)

        def forward(self, x):
            return pt.matmul(x, self.fc.weight, transpose_y=True) * 2.0 \
                + self.fc(x)

    net = T()
    _, graph = _export_and_parse(pt.onnx.export, net,
                                 [InputSpec([None, 4], "float32")],
                                 tmp_path / "tf")
    ops = [n["op_type"] for n in graph["nodes"]]
    assert ops.count("Transpose") == 2 and "Mul" in ops
    assert ops.count("Add") == 2
    w = next(t for t in graph["initializers"] if t["name"] == "fc.weight")
    assert w["dims"] == [4, 3]
    np.testing.assert_array_equal(
        np.frombuffer(w["raw"], np.float32).reshape(4, 3),
        net.fc.weight.detach().numpy().T)
