"""The port's op registry and dispatch layer (paddle_tpu_torch/ops/registry.py,
paddle_tpu_torch/framework/dispatch.py) and the framework modules under
them (dtypes, place, flags, monitor, enforce, tensor), against the JAX
package's.

Every registered op's plain body is held against the JAX op of the same
name (``paddle_tpu.ops.registry.get_op(name).fn``) on the same numpy
inputs, and ``layer_norm`` and ``scaled_dot_product_attention`` through
``call_op`` against the JAX ``call_op``, with the JAX package's Pallas
kernels in interpret mode and without them. On CPU tensors the kernel
wrappers count no launch. Tolerance: float32 atol 1e-5 (the same f32
arithmetic in another summation order); integer and shape ops exact.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework import dtypes as jax_dtypes
from paddle_tpu.framework.dispatch import call_op as jax_call_op
from paddle_tpu.framework.flags import set_flags as jax_set_flags
from paddle_tpu.framework.tensor import Tensor as JaxTensor
from paddle_tpu.ops import registry as jax_registry
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp
from paddle_tpu_torch.framework import dtypes, enforce, flags, monitor, place
from paddle_tpu_torch.framework.dispatch import call_op
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import layer_norm as ln
from paddle_tpu_torch.ops import registry

ATOL = 1e-5


@pytest.fixture
def scratch_ops():
    """Op names a test registers, removed from the registry afterwards."""
    names = []
    yield names
    for n in names:
        registry._OPS.pop(n, None)


@pytest.fixture
def cpu_default():
    """The CPU as the default place for the test's duration."""
    old = place.current_place()
    place.set_device("cpu")
    yield
    place.set_device(old)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- registry ------------------------------------------------------------

def test_register_op_twice_raises(scratch_ops):
    scratch_ops.append("_test_twice")
    registry.register_op("_test_twice")(lambda x: x)
    with pytest.raises(KeyError, match="already registered"):
        registry.register_op("_test_twice")(lambda x: x)


def test_get_op_of_an_unknown_name_raises():
    with pytest.raises(NotImplementedError, match="not registered"):
        registry.get_op("_no_such_op")
    with pytest.raises(NotImplementedError, match="not registered"):
        call_op("_no_such_op", 1)
    assert not registry.has_op("_no_such_op")
    assert registry.has_op("layer_norm")


def test_overrides_are_tried_newest_first(scratch_ops):
    scratch_ops.append("_test_order")
    registry.register_op("_test_order")(lambda x: "plain")
    registry.register_override("_test_order", lambda a, k: a[0] > 0)(
        lambda x: "old")
    registry.register_override("_test_order", lambda a, k: a[0] > 1)(
        lambda x: "new")
    assert [call_op("_test_order", x) for x in (0, 1, 2)] == \
        ["plain", "old", "new"]


def test_a_raising_predicate_propagates(scratch_ops):
    """The JAX registry swallows a predicate's exception and runs the
    generic op; the port's must not, or the plain version would quietly
    stand in for the kernel."""
    def bad(args, attrs):
        raise RuntimeError("predicate failed")

    scratch_ops.append("_test_raise")
    registry.register_op("_test_raise")(lambda x: "plain")
    registry.register_override("_test_raise", bad)(lambda x: "kernel")
    with pytest.raises(RuntimeError, match="predicate failed"):
        call_op("_test_raise", 1)
    jax_def = jax_registry.OpDef("_test_raise", lambda x: "plain",
                                 nondiff=False, jit=False)
    jax_def.overrides.append((bad, lambda x: "kernel"))
    assert jax_def.select((1,), {})(1) == "plain"      # swallowed there


def test_op_names_are_the_jax_names():
    jax_names = set(jax_registry.op_names())
    for name in registry.op_names():
        if name != "zeros":               # a creation function in JAX
            assert name in jax_names, name


# -- call_op -------------------------------------------------------------

def test_op_count_counts_calls():
    x = torch.ones(3)
    before = monitor.stat_get("op_count/add")
    for _ in range(4):
        call_op("add", x, x)
    pt.add(x, x)
    assert monitor.stat_get("op_count/add") == before + 5


def test_check_nan_inf_raises_on_a_nan_output():
    x = torch.tensor([1.0, float("nan")])
    assert torch.isnan(call_op("multiply", x, x)).any()    # off: passes
    flags.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="multiply"):
            call_op("multiply", x, x)
        call_op("multiply", torch.ones(2), torch.ones(2))
    finally:
        flags.set_flags({"FLAGS_check_nan_inf": False})


def test_benchmark_flag_times_each_op():
    before = monitor.stat_get("op_time_ms/maximum")
    flags.set_flags({"FLAGS_benchmark": True})
    try:
        call_op("maximum", torch.ones(4), torch.zeros(4))
    finally:
        flags.set_flags({"FLAGS_benchmark": False})
    assert monitor.stat_get("op_time_ms/maximum") > before


def test_call_op_applies_the_amp_policy():
    x = torch.randn(2, 8)
    w, b = torch.randn(8, 4), torch.randn(4)
    with amp.auto_cast(level="O2"):
        assert call_op("linear", x, w, b).dtype == torch.bfloat16
        y = call_op("layer_norm", x.bfloat16(), torch.ones(8).bfloat16(),
                    torch.zeros(8).bfloat16())
        assert y.dtype == torch.float32
        cat = call_op("concat", [x, x], axis=0)
        assert cat.dtype == torch.bfloat16
        ids = call_op("cumsum", torch.ones(3, dtype=torch.int32), axis=0)
        assert ids.dtype == torch.int32
    assert call_op("linear", x, w, b).dtype == torch.float32


@pytest.mark.parametrize("shape, d", [((5,), 48), ((2, 7), 768)])
def test_layer_norm_through_call_op_matches_the_jax_ops(shape, d):
    x, w, b = _rand(1, *shape, d), 1 + 0.1 * _rand(2, d), _rand(3, d)
    launches = ln.fused_layer_norm.launches
    got = call_op("layer_norm", *map(torch.from_numpy, (x, w, b)),
                  epsilon=1e-5).numpy()
    assert ln.fused_layer_norm.launches == launches
    for force in (False, True):
        jax_set_flags({"FLAGS_pallas_force": force})
        try:
            want = jax_call_op("layer_norm",
                               *(JaxTensor(jnp.asarray(a)) for a in (x, w, b)),
                               epsilon=1e-5).numpy()
        finally:
            jax_set_flags({"FLAGS_pallas_force": False})
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["causal", "full", "bool_mask",
                                  "additive_mask"])
def test_sdpa_through_call_op_matches_the_jax_ops(case):
    b, s, h, d = 2, 16, 2, 8
    q, k, v = (_rand(i, b, s, h, d) for i in (4, 5, 6))
    attrs = {"is_causal": case == "causal"}
    if case == "bool_mask":
        attrs["mask"] = np.random.RandomState(7).rand(b, 1, 1, s) > 0.3
        attrs["mask"][..., 0] = True
    elif case == "additive_mask":
        attrs["mask"] = _rand(8, b, 1, s, s)
    launches = fa.flash_attention_fwd.launches
    got = call_op("scaled_dot_product_attention",
                  *map(torch.from_numpy, (q, k, v)),
                  **{n: torch.from_numpy(a) if isinstance(a, np.ndarray)
                     else a for n, a in attrs.items()}).numpy()
    assert fa.flash_attention_fwd.launches == launches
    for force in (False, True):
        jax_set_flags({"FLAGS_pallas_force": force})
        try:
            want = jax_call_op(
                "scaled_dot_product_attention",
                *(JaxTensor(jnp.asarray(a)) for a in (q, k, v)),
                **{n: JaxTensor(jnp.asarray(a)) if isinstance(a, np.ndarray)
                   else a for n, a in attrs.items()}).numpy()
        finally:
            jax_set_flags({"FLAGS_pallas_force": False})
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_overrides_pick_the_kernels_by_operand():
    """``layer_norm`` goes to the kernel wrapper only for an operand on the
    card; attention whenever the structural half of ``_fa_supported``
    holds, on any device (the wrapper runs its plain version on the
    CPU)."""
    x = torch.randn(2, 4, 2, 8)
    w, b = torch.ones(8), torch.zeros(8)
    ln_op = registry.get_op("layer_norm")
    assert ln_op.select((x, w, b), {}) is ln_op.fn
    sdpa = registry.get_op("scaled_dot_product_attention")
    assert sdpa.select((x, x, x), {"is_causal": True}) is not sdpa.fn
    assert sdpa.select((x, x, x), {"mask": x > 0}) is sdpa.fn
    assert sdpa.select((x, x, x), {"dropout_p": 0.1}) is sdpa.fn


# -- each op's plain body against the JAX op ----------------------------

def _case(name):
    a, b = _rand(10, 3, 4), _rand(11, 3, 4)
    ids = np.array([[1, 0, 3], [2, 2, 0]], np.int64)
    table = _rand(12, 5, 4)
    return {
        "add": ((a, b), {}), "multiply": ((a, b), {}),
        "maximum": ((a, b), {}),
        "matmul": ((a, b), {"transpose_y": True}),
        "matmul_tx": ((a, b), {"transpose_x": True}),
        "cumsum": ((np.arange(12, dtype=np.int32).reshape(3, 4),),
                   {"axis": 1}),
        "cumsum_flat": ((a,), {}),
        "concat": (([a, b],), {"axis": 1}),
        "slice": ((a,), {"axes": [1], "starts": [1], "ends": [3]}),
        "reshape": ((a,), {"shape": (0, 2, 2)}),
        "transpose": ((a,), {"perm": (1, 0)}),
        "embedding": ((ids, table), {}),
        "embedding_pad": ((ids, table), {"padding_idx": 0}),
        "linear": ((a, _rand(13, 4, 6), _rand(14, 6)), {}),
        "gelu": ((a,), {}), "gelu_tanh": ((a,), {"approximate": True}),
        "softmax": ((a,), {"axis": 0}),
    }[name]


@pytest.mark.parametrize("case", [
    "add", "multiply", "maximum", "matmul", "matmul_tx", "cumsum",
    "cumsum_flat", "concat", "slice", "reshape", "transpose", "embedding",
    "embedding_pad", "linear", "gelu", "gelu_tanh", "softmax"])
def test_plain_bodies_match_the_jax_ops(case):
    name = case.split("_")[0]
    args, attrs = _case(case)

    def conv(x, f):
        return [f(a) for a in x] if isinstance(x, list) else f(x)

    got = call_op(name, *(conv(a, torch.from_numpy) for a in args), **attrs)
    want = jax_registry.get_op(name).fn(
        *(conv(a, jnp.asarray) for a in args), **attrs)
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    if want.dtype.kind in "iu":
        assert got.dtype == {4: torch.int32, 8: torch.int64}[
            want.dtype.itemsize]
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_creation_ops_match_the_jax_ops_and_default_to_the_card():
    for name, attrs in (("full", {"shape": (2, 3), "fill_value": 1.5}),
                        ("arange", {"start": 2, "end": 9, "step": 3}),
                        ("arange", {"start": 5})):
        got = call_op(name, device="cpu", **attrs)
        want = np.asarray(jax_registry.get_op(name).fn(**attrs))
        np.testing.assert_array_equal(got.numpy(), want)
    zeros = call_op("zeros", (2, 2), dtype="bfloat16", device="cpu")
    assert zeros.dtype == torch.bfloat16 and not zeros.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call_op("zeros", (2,))


def test_registered_ops_are_top_level_functions():
    for name in registry.op_names():
        fn = getattr(pt, name)
        assert fn.__name__ == name
    x = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(pt.transpose(x, [1, 0]).numpy(),
                                  x.numpy().T)


# -- tensor, place, dtypes, flags, enforce --------------------------------

def test_to_tensor_defaults_to_the_card():
    if torch.cuda.is_available():
        assert pt.to_tensor([1.0]).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.to_tensor([1.0])
    assert pt.get_device() == "gpu:0"


def test_to_tensor_on_the_cpu_and_its_gradient_semantics(cpu_default):
    t = pt.to_tensor([1.5, 2.0])
    assert t.device.type == "cpu" and t.dtype == torch.float32
    assert not t.requires_grad                  # stop_gradient=True
    assert pt.to_tensor(3).dtype == torch.int64
    assert pt.to_tensor(np.zeros(2)).dtype == torch.float32
    assert pt.to_tensor(True).dtype == torch.bool
    src = np.ones(3, np.float32)
    g = pt.to_tensor(src, dtype="bfloat16", place="cpu",
                     stop_gradient=False)
    assert g.dtype == torch.bfloat16 and g.requires_grad and g.is_leaf
    src[0] = 5
    assert g[0] == 1                            # a copy
    again = pt.to_tensor(g)
    assert not again.requires_grad and again.data_ptr() != g.data_ptr()
    assert pt.to_tensor(g, dtype="float32").dtype == torch.float32
    p = pt.Parameter(torch.zeros(2))
    assert p.requires_grad and not p.detach().requires_grad


def test_no_grad_and_grad_guards():
    w = torch.ones(2, requires_grad=True)
    with pt.no_grad():
        assert not pt.is_grad_enabled()
        assert not (w * 2).requires_grad
        with pt.grad_enabled_guard(True):
            assert (w * 2).requires_grad

    @pt.no_grad()
    def f():
        return w * 2

    assert not f().requires_grad and pt.is_grad_enabled()


def test_dtype_names_round_trip_against_the_jax_package():
    for alias in jax_dtypes._STR_ALIASES:
        if alias == "uint32" and not hasattr(torch, "uint32"):
            continue
        d = dtypes.convert_dtype(alias)
        assert dtypes.dtype_name(d) == jax_dtypes.convert_dtype(alias).name
        assert dtypes.convert_dtype(dtypes.dtype_name(d)) is d
    assert dtypes.convert_dtype("float8_e4m3fn") is torch.float8_e4m3fn
    assert dtypes.convert_dtype(np.float16) is torch.float16
    assert dtypes.convert_dtype(None) is torch.float32
    assert pt.bfloat16 is torch.bfloat16 and pt.int32 is torch.int32
    with pytest.raises(TypeError, match="Unsupported"):
        dtypes.convert_dtype("float7")


def test_places_round_trip(cpu_default):
    assert place.to_torch_device("cpu") == torch.device("cpu")
    for p, dev in ((place.CPUPlace(), torch.device("cpu")),
                   (place.CUDAPlace(1), torch.device("cuda", 1))):
        assert place.from_torch_device(dev) == p
    assert pt.get_device() == "cpu:0"
    assert pt.set_device("gpu:1") == place.CUDAPlace(1)
    assert pt.get_device() == "gpu:1"
    assert place.current_place() == place.CUDAPlace(1)
    with pytest.raises(ValueError, match="Unknown device"):
        pt.set_device("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            place.to_torch_device(place.CUDAPlace(1))


def test_flags_get_and_set():
    assert flags.get_flags(["check_nan_inf", "FLAGS_benchmark"]) == {
        "FLAGS_check_nan_inf": False, "FLAGS_benchmark": False}
    with pytest.raises(ValueError, match="not registered"):
        flags.get_flags("FLAGS_pallas_force")
    with pytest.raises(ValueError, match="not registered"):
        flags.set_flags({"FLAGS_pallas_force": True})


def test_error_types_match_the_jax_package():
    jax_enforce = importlib.import_module("paddle_tpu.framework.enforce")
    for name in ("InvalidArgumentError", "NotFoundError", "OutOfRangeError",
                 "AlreadyExistsError", "PreconditionNotMetError",
                 "UnimplementedError", "UnavailableError"):
        ours, theirs = getattr(enforce, name), getattr(jax_enforce, name)
        assert issubclass(ours, enforce.EnforceNotMet)
        assert [c.__name__ for c in ours.__mro__] == \
            [c.__name__ for c in theirs.__mro__]
    with pytest.raises(ValueError):
        raise enforce.InvalidArgumentError("bad")


def test_monitor_counts_and_snapshots():
    before = monitor.stat_get("_test/counter")
    monitor.stat_add("_test/counter", 2)
    monitor.stat_add("_test/counter")
    snap = monitor.all_stats()
    assert snap["_test/counter"] == before + 3
    monitor.stat_add("_test/counter")
    assert snap["_test/counter"] == before + 3       # a copy
    assert monitor.stat_get("_no/such/counter") == 0
