"""The port's ``sequence_ops`` and their ``nn.functional`` wrappers against
the JAX package's, on the CPU.

* Every case of the 13 ops in ``paddle_tpu_torch.ops.op_cases`` (a dense
  ``[3, 5, ...]`` batch with lengths 3, 5 and 1; every pool type, float
  and integer; two context windows of ``sequence_conv``), as
  ``test_torch_ops_library.py`` holds the rest of the library: floats
  within atol 1e-5 + rtol 1e-5, integers exactly and with the JAX op's
  dtype.
* The gradient of each differentiable op with respect to its float
  inputs, against ``jax.grad`` of the JAX op under the same random
  cotangent, within atol 1e-5 + rtol 1e-5.
* Each of the ten ``nn.functional.sequence_*`` wrappers against the JAX
  wrapper on the same call.
* Nothing reads a length back to the host: the ops run with their
  lengths on the ``meta`` device (no values at all) and give the JAX
  op's output shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch.framework.dispatch import call_op
from paddle_tpu_torch.nn import functional as TF
from test_torch_ops_library import (ATOL, CASES, RTOL, SEQUENCE,
                                    check_against_jax)

KEYS = sorted(k for k, c in CASES.items() if c.name in SEQUENCE)


def test_every_sequence_op_has_a_case():
    assert {CASES[k].name for k in KEYS} == set(SEQUENCE)


@pytest.mark.parametrize("key", KEYS)
def test_op_matches_the_jax_op(key):
    check_against_jax(key)


def _float_slots(case):
    """Positions of the float array arguments (lists flattened as
    ``(i, j)``)."""
    out = []
    for i, a in enumerate(case.args):
        if isinstance(a, np.ndarray) and a.dtype.kind == "f":
            out.append((i, None))
        elif isinstance(a, list):
            out += [(i, j) for j, v in enumerate(a) if v.dtype.kind == "f"]
    return out


GRAD_KEYS = [k for k in KEYS if _float_slots(CASES[k])
             and CASES[k].check == "close"]


@pytest.mark.parametrize("key", GRAD_KEYS)
def test_gradient_matches_jax_grad(key):
    case = CASES[key]
    slots = _float_slots(case)
    rs = np.random.RandomState(11)

    def pick(args, i, j):
        return args[i] if j is None else args[i][j]

    def first(out):
        return out[0] if isinstance(out, (list, tuple)) else out

    def jax_loss(*floats, cot):
        args = [list(a) if isinstance(a, list) else a for a in case.args]
        args = [jnp.asarray(a) if isinstance(a, np.ndarray) else
                [jnp.asarray(v) for v in a] if isinstance(a, list) else a
                for a in args]
        for (i, j), f in zip(slots, floats):
            if j is None:
                args[i] = f
            else:
                args[i][j] = f
        out = first(jax_registry.get_op(case.name).fn(*args, **case.attrs))
        return (out * cot).sum()

    jout = first(jax_registry.get_op(case.name).fn(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else
          [jnp.asarray(v) for v in a] if isinstance(a, list) else a
          for a in case.args], **case.attrs))
    cot = rs.randn(*jout.shape).astype(np.float32)
    floats = [jnp.asarray(pick(case.args, i, j)) for i, j in slots]
    want = jax.grad(lambda *f: jax_loss(*f, cot=cot),
                    argnums=tuple(range(len(floats))))(*floats)

    targs = [torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else
             [torch.from_numpy(np.array(v)) for v in a]
             if isinstance(a, list) else a for a in case.args]
    leaves = []
    for i, j in slots:
        t = pick(targs, i, j).requires_grad_()
        leaves.append(t)
    out = first(call_op(case.name, *targs, **case.attrs))
    (out * torch.from_numpy(cot)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=ATOL, rtol=RTOL, err_msg=key)


def _wrapper_calls():
    rs = np.random.RandomState(2)
    x = rs.randn(3, 5, 4).astype(np.float32)
    lengths = np.array([4, 2, 5], np.int64)
    ids = rs.randint(1, 20, (3, 5)).astype(np.int64)
    w = rs.randn(12, 2).astype(np.float32)
    return {
        "sequence_pad": ((rs.randn(11, 2).astype(np.float32), lengths),
                         dict(pad_value=0.25, maxlen=5)),
        "sequence_unpad": ((x, lengths), dict(total_length=13)),
        "sequence_pool": ((x, lengths), dict(pool_type="sqrt")),
        "sequence_softmax": ((x[..., 0], lengths), {}),
        "sequence_reverse": ((x, lengths), {}),
        "sequence_expand": ((x[:, 0], lengths), dict(maxlen=6)),
        "sequence_slice": ((x, lengths, np.array([1, 0, 2], np.int64),
                            np.array([3, 2, 2], np.int64)), {}),
        "sequence_enumerate": ((ids, lengths, 2), dict(pad_value=-1)),
        "sequence_concat": (([x, x[:, :3]],
                             [lengths, np.array([1, 3, 0], np.int64)]),
                            dict(maxlen=8)),
        "sequence_conv": ((x, lengths, w), dict(context_start=-2)),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_functional_wrapper_matches_jax(name):
    args, kw = _wrapper_calls()[name]

    def conv(a, fn):
        if isinstance(a, np.ndarray):
            return fn(a)
        if isinstance(a, list):
            return [fn(v) for v in a]
        return a

    got = getattr(TF, name)(*[conv(a, torch.from_numpy) for a in args],
                            **kw)
    want = getattr(JF, name)(*[conv(a, paddle.to_tensor) for a in args],
                             **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        w = np.asarray(w.numpy())
        g = g.numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("key", KEYS)
def test_no_length_is_read_back(key):
    """On ``meta`` tensors every value is absent: an op that read a length
    (or any value) to the host would raise. The shapes are the JAX op's."""
    case = CASES[key]

    def meta(a):
        if isinstance(a, np.ndarray):
            return torch.empty(a.shape, dtype=torch.from_numpy(
                np.array(a)).dtype, device="meta")
        if isinstance(a, list):
            return [meta(v) for v in a]
        return a

    got = call_op(case.name, *[meta(a) for a in case.args], **case.attrs)
    want = jax_registry.get_op(case.name).fn(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else
          [jnp.asarray(v) for v in a] if isinstance(a, list) else a
          for a in case.args], **case.attrs)
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert all(g.device.type == "meta" for g in got)
