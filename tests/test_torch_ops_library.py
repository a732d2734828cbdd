"""The port's op library against the JAX package's, op by op.

Every op of ``paddle_tpu/ops``' ``math_ops``, ``extra_math_ops``,
``creation_ops``, ``manipulation_ops``, ``linalg_ops``, ``nn_ops``,
``extra_nn_ops`` and ``sequence_ops`` is registered in the port
(``DEFERRED`` lists, by name,
the JAX ops that wait for later slices, and ``ROADMAP.md`` names each in
full). Each op's plain body runs on the inputs of its case in
``paddle_tpu_torch.ops.op_cases`` (the ops from ``a`` to ``l`` here, the
rest in ``test_torch_ops_library_m_z.py``, ``extra_nn_ops``' in
``test_torch_extra_nn_ops.py``, ``sequence_ops``' in
``test_torch_sequence_ops.py``)
(numpy, from a seed) in both packages: float results within atol 1e-5 +
rtol 1e-5 (the same f32 arithmetic in another order; a case may state a
wider one, 1e-4 for the decompositions and solves), integer and bool
results exactly and with the JAX op's dtype; the samplers in
distribution only (mean and variance within 5 standard errors, support),
since the JAX key and the torch generator give different streams; the
decompositions unique only up to signs by their defining identities.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import registry as jax_registry
import paddle_tpu.vision.ops  # noqa: F401  (registers the vision ops)
from paddle_tpu_torch.framework.dispatch import call_op
from paddle_tpu_torch.ops import op_cases, registry

ATOL = RTOL = 1e-5

#: the JAX ops the port leaves for a later slice: ``vision.ops`` (ROADMAP
#: Queue 1 item 5)
DEFERRED = {
    "deform_conv2d": 5, "nms": 5, "psroi_pool": 5, "roi_align": 5,
    "roi_pool": 5, "yolo_box": 5, "yolo_loss": 5,
}

#: the ops of ``extra_nn_ops``, swept in ``test_torch_extra_nn_ops.py``
EXTRA_NN = frozenset((
    "adaptive_avg_pool3d", "adaptive_max_pool3d", "affine_grid",
    "channel_shuffle", "class_center_sample", "conv1d_transpose",
    "conv3d_transpose", "ctc_loss", "fold", "gather_tree", "grid_sample",
    "hsigmoid_loss", "margin_cross_entropy", "max_pool1d_with_mask",
    "max_pool2d_with_mask", "max_pool3d_with_mask", "max_unpool1d",
    "max_unpool2d", "max_unpool3d", "pixel_unshuffle", "sparse_attention",
    "temporal_shift"))

#: the ops of ``sequence_ops``, swept in ``test_torch_sequence_ops.py``
SEQUENCE = frozenset((
    "nce_loss", "row_conv", "sequence_concat", "sequence_conv",
    "sequence_enumerate", "sequence_expand", "sequence_pad",
    "sequence_pool", "sequence_reverse", "sequence_scatter",
    "sequence_slice", "sequence_softmax", "sequence_unpad"))

CASES = op_cases.cases()


def _convert(value, array, key):
    if isinstance(value, str) and value == op_cases.KEY:
        return key()
    if isinstance(value, (np.ndarray, np.generic)):
        return array(value)
    if isinstance(value, list) and value and all(
            isinstance(v, np.ndarray) for v in value):
        return [array(v) for v in value]
    return value


def run_port(case):
    def conv(a):
        return _convert(a, lambda v: torch.from_numpy(np.array(v)),
                        lambda: torch.Generator().manual_seed(0))

    args = [conv(a) for a in case.args]
    attrs = {k: conv(v) for k, v in case.attrs.items()}
    if case.creation:
        attrs["device"] = "cpu"
    return op_cases.to_numpy_tree(call_op(case.name, *args, **attrs))


def run_jax(case):
    def conv(a):
        return _convert(a, jnp.asarray, lambda: jax.random.PRNGKey(0))

    out = jax_registry.get_op(case.name).fn(
        *[conv(a) for a in case.args],
        **{k: conv(v) for k, v in case.attrs.items()})
    return op_cases.to_numpy_tree(out)


def test_the_library_covers_the_jax_ops_but_the_deferred():
    jax_names, port_names = set(jax_registry.op_names()), \
        set(registry.op_names())
    assert set(DEFERRED) <= jax_names
    assert jax_names - set(DEFERRED) <= port_names
    assert port_names - jax_names == {"zeros"}
    assert registry.DEFERRED == DEFERRED
    assert len(jax_names - set(DEFERRED)) == 352
    assert EXTRA_NN <= port_names and SEQUENCE <= port_names
    roadmap = (pathlib.Path(__file__).parents[1] / "ROADMAP.md").read_text()
    missing = [n for n in DEFERRED if f"`{n}`" not in roadmap]
    assert missing == [], missing


@pytest.mark.parametrize("name", sorted(DEFERRED))
def test_a_deferred_op_names_its_item(name):
    with pytest.raises(NotImplementedError,
                       match=f"Queue 1 item {DEFERRED[name]}"):
        call_op(name, torch.zeros(2))


def test_every_op_has_a_case():
    assert {c.name for c in CASES.values()} == set(registry.op_names())


def keys(first, last):
    """The case keys of the ops whose name starts with a letter in
    ``[first, last]``, less ``extra_nn_ops``' and ``sequence_ops``' (the
    sweep is split over four files so that each runs in about a minute on
    one worker)."""
    return sorted(k for k, c in CASES.items()
                  if c.name != "zeros" and c.name not in EXTRA_NN
                  and c.name not in SEQUENCE and first <= k[0] <= last)


def check_against_jax(key):
    case = CASES[key]
    op_cases.check(case, run_port(case), run_jax(case), ATOL, RTOL)


@pytest.mark.parametrize("key", keys("a", "l"))
def test_op_matches_the_jax_op(key):
    check_against_jax(key)


def test_put_along_axis_add_adds():
    """``reduce="add"`` adds into the input. (The JAX op sets there, as its
    ``jnp.put_along_axis`` sets; its ``"assign"`` and ``"multiply"`` are
    held above.)"""
    x = torch.ones(2, 3)
    idx = torch.tensor([[1, 1], [0, 2]])
    got = call_op("put_along_axis", x, idx, torch.full((2, 2), 2.0), axis=1,
                  reduce="add")
    np.testing.assert_array_equal(got.numpy(), [[1, 5, 1], [3, 1, 3]])


def test_setitem_leaves_its_input_alone():
    x = torch.zeros(3, 4)
    out = call_op("setitem", x, torch.tensor(5.0), index_spec=(
        ("slice", None, None, -1), ("int", 2)))
    assert not x.any()
    assert out[:, 2].eq(5).all() and out.sum() == 15
