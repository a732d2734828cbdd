"""The detection ops of the port (``paddle_tpu_torch/ops/vision_ops.py``,
``paddle_tpu_torch/vision/ops.py``) against the JAX package's
``paddle_tpu/vision/ops.py``, on the CPU, on inputs made by numpy from a
seed (``ops/op_cases.py``'s ``_vision_cases``).

- Values: each op's case within atol 1e-5 + rtol 1e-5 (float32; the
  port sums ``roi_align``'s samples as two products and ``psroi_pool``'s
  as two contractions, in another order), NMS indices exactly.
- Gradients: ``test_torch_vision_grads.py``.
- The functional forms and layers (``RoIAlign``, ``RoIPool``,
  ``PSRoIPool``, ``DeformConv2D`` with its weights carried across), the
  categorical ``nms``, ``read_file`` and ``decode_jpeg`` against the JAX
  ones.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.vision.ops as jax_vops
from paddle_tpu.framework.tensor import Tensor as JaxTensor
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch.convert import layer_from_jax
from paddle_tpu_torch.framework.dispatch import call_op
from paddle_tpu_torch.ops import op_cases
from paddle_tpu_torch.vision import ops as vops

from test_torch_ops_library import ATOL, CASES, RTOL, VISION, \
    check_against_jax

KEYS = sorted(k for k, c in CASES.items() if c.name in VISION)


def test_every_detection_op_has_a_case():
    assert {CASES[k].name for k in KEYS} == set(VISION)


@pytest.mark.parametrize("key", KEYS)
def test_detection_op_matches_jax(key):
    check_against_jax(key)


def test_the_nms_cases_suppress():
    case = CASES["nms"]
    kept = call_op("nms", *[torch.from_numpy(a) for a in case.args],
                   **case.attrs)
    assert 0 < kept.numel() < len(case.args[0])
    assert 1 in kept.tolist() and 3 not in kept.tolist()


def _jt(a):
    return JaxTensor(jnp.asarray(a))


def test_categorical_nms_matches_jax():
    rs = np.random.RandomState(5)
    b = op_cases._boxes(rs, 40, 20, 20)
    s = rs.rand(40).astype(np.float32)
    s[7] = s[9]                                   # a tie across categories
    cat = rs.randint(0, 4, 40).astype(np.int64)
    for cats, top_k in (((0, 1, 2, 3), None), ((3, 1), 6)):
        want = np.asarray(jax_vops.nms(
            _jt(b), 0.3, _jt(s), _jt(cat), list(cats), top_k)._data)
        got = vops.nms(torch.from_numpy(b), 0.3, torch.from_numpy(s),
                       torch.from_numpy(cat), list(cats), top_k)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="categories"):
        vops.nms(torch.from_numpy(b), 0.3, torch.from_numpy(s),
                 torch.from_numpy(cat))


def test_region_layers_match_jax():
    """The layers against the JAX ones run op by op (``jax.disable_jit``):
    the jitted JAX op may fuse a bin's end ``ceil((j + 1) * bin + x1)``
    into another rounding, which moves an end that lands on an integer
    by one cell (``test_an_integer_bin_end_is_not_moved``)."""
    rs = np.random.RandomState(2)
    x = rs.randn(2, 8, 9, 11).astype(np.float32)
    boxes = op_cases._boxes(rs, 6, 9, 11, scale=0.25)
    num = np.array([4, 2], np.int32)
    for jax_layer, layer in (
            (jax_vops.RoIAlign(3, 0.25), vops.RoIAlign(3, 0.25)),
            (jax_vops.RoIPool((2, 3), 0.25), vops.RoIPool((2, 3), 0.25)),
            (jax_vops.PSRoIPool(2, 0.25), vops.PSRoIPool(2, 0.25))):
        with jax.disable_jit():
            want = np.asarray(jax_layer(_jt(x), _jt(boxes),
                                        _jt(num))._data)
        got = layer(torch.from_numpy(x), torch.from_numpy(boxes),
                    torch.from_numpy(num))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_an_integer_bin_end_is_not_moved():
    """A box 7 cells wide in 3 bins: the last bin ends at ``ceil(3 * (7 /
    3)) = 7``, as the JAX op's plain body computes it; the jitted JAX op
    ends it at 8 (a reference artifact, ROADMAP Queue 3)."""
    x = np.arange(2 * 1 * 4 * 10, dtype=np.float32).reshape(2, 1, 4, 10)
    boxes = np.array([[0.0, 0.0, 6.0, 3.0]], np.float32)
    got = vops.roi_pool(torch.from_numpy(x[:1]), torch.from_numpy(boxes),
                        [1], (1, 3)).numpy()
    want = np.asarray(jax_registry.get_op("roi_pool").fn(
        jnp.asarray(x[:1]), jnp.asarray(boxes), boxes_num=(1,),
        output_size=(1, 3)))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0, 2] == x[0, 0, 3, 6]    # cells 4..6, not 4..7


def test_deform_conv2d_layer_matches_jax_with_carried_weights():
    paddle.seed(3)
    jax_layer = jax_vops.DeformConv2D(4, 6, 3, padding=1,
                                      deformable_groups=2)
    layer = vops.DeformConv2D(4, 6, 3, padding=1, deformable_groups=2)
    layer_from_jax(layer, {k: np.asarray(v._data)
                           for k, v in jax_layer.state_dict().items()})
    rs = np.random.RandomState(4)
    x = rs.randn(2, 4, 6, 6).astype(np.float32)
    off = rs.randn(2, 36, 6, 6).astype(np.float32)
    mask = rs.rand(2, 18, 6, 6).astype(np.float32)
    for m in (None, mask):
        want = np.asarray(jax_layer(_jt(x), _jt(off), None if m is None
                                    else _jt(m))._data)
        got = layer(torch.from_numpy(x), torch.from_numpy(off),
                    None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                                   rtol=RTOL)


def test_functional_yolo_forms_match_jax():
    case = CASES["yolo_loss"]
    head, gt, labels = case.args
    attrs = case.attrs
    want = np.asarray(jax_vops.yolo_loss(
        _jt(head), _jt(gt), _jt(labels), attrs["anchors"],
        attrs["anchor_mask"], attrs["class_num"], attrs["ignore_thresh"],
        attrs["downsample_ratio"])._data)
    got = vops.yolo_loss(torch.from_numpy(head), torch.from_numpy(gt),
                         torch.from_numpy(labels), attrs["anchors"],
                         attrs["anchor_mask"], attrs["class_num"],
                         attrs["ignore_thresh"], attrs["downsample_ratio"])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    size = np.array([[160, 160], [150, 170]], np.int32)
    jb, js = jax_vops.yolo_box(_jt(head), _jt(size), attrs["anchors"][:6], 4)
    pb, ps = vops.yolo_box(torch.from_numpy(head), torch.from_numpy(size),
                           attrs["anchors"][:6], 4)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb._data), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js._data), atol=ATOL,
                               rtol=RTOL)


def test_read_file_and_decode_jpeg_match_jax(tmp_path):
    from PIL import Image
    rs = np.random.RandomState(6)
    for mode, shape in (("RGB", (12, 10, 3)), ("L", (12, 10))):
        path = tmp_path / f"im_{mode}.jpg"
        Image.fromarray(rs.randint(0, 255, shape).astype(np.uint8),
                        mode).save(path, quality=90)
        raw = vops.read_file(str(path))
        want_raw = np.asarray(jax_vops.read_file(str(path))._data)
        assert raw.dtype == torch.uint8
        np.testing.assert_array_equal(raw.numpy(), want_raw)
        for how in ("unchanged", "gray", "rgb"):
            want = np.asarray(jax_vops.decode_jpeg(
                jax_vops.read_file(str(path)), mode=how)._data)
            got = vops.decode_jpeg(raw, mode=how)
            np.testing.assert_array_equal(got.numpy(), want)
    buf = io.BytesIO()
    Image.new("RGB", (4, 3)).save(buf, format="JPEG")
    assert tuple(vops.decode_jpeg(np.frombuffer(buf.getvalue(),
                                                np.uint8)).shape) == (3, 3, 4)
