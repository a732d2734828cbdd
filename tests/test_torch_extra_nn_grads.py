"""The gradients of the port's ``extra_nn_ops`` against the JAX
package's on the CPU (their values: ``test_torch_extra_nn_ops.py``): the
first case (the one keyed by the op's name) of every differentiable op in
``paddle_tpu_torch.ops.op_cases``, the same cotangent through both ops (``jax.grad`` on the JAX side), each
floating input's gradient within atol 1e-5 + rtol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch.framework.dispatch import call_op
from test_torch_extra_nn_ops import KEYS
from test_torch_ops_library import ATOL, CASES, RTOL

#: cases whose result carries no gradient (integers, a sampler)
NONDIFF = {"gather_tree", "class_center_sample"}


def _float_args(case):
    return [i for i, a in enumerate(case.args)
            if isinstance(a, np.ndarray) and a.dtype == np.float32]


@pytest.mark.parametrize("key", [k for k in KEYS if k == CASES[k].name
                                 and k not in NONDIFF])
def test_gradient_matches_the_jax_op(key):
    case = CASES[key]
    diff = _float_args(case)
    rs = np.random.RandomState(7)

    def cotangents(outs):
        return [rs.randn(*np.shape(o)).astype(np.float32) for o in outs]

    # the port
    targs = [torch.tensor(a, requires_grad=i in diff)
             if isinstance(a, np.ndarray) else a
             for i, a in enumerate(case.args)]
    out = call_op(case.name, *targs, **case.attrs)
    outs = [o for o in (out if isinstance(out, (list, tuple)) else [out])
            if o.is_floating_point()]
    cots = cotangents(outs)
    sum(((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
        ).backward()
    # an input autograd does not reach (the nearest sampler's grid) has
    # JAX's zero gradient
    got = [np.zeros_like(case.args[i]) if targs[i].grad is None
           else targs[i].grad.numpy() for i in diff]

    # the JAX op
    fn = jax_registry.get_op(case.name).fn

    def f(*floats):
        args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
                for a in case.args]
        for i, v in zip(diff, floats):
            args[i] = v
        res = fn(*args, **case.attrs)
        res = [r for r in (res if isinstance(res, (list, tuple)) else [res])
               if jnp.issubdtype(r.dtype, jnp.floating)]
        return sum(jnp.sum(r * c) for r, c in zip(res, cots))

    want = jax.grad(f, argnums=tuple(range(len(diff))))(
        *[jnp.asarray(case.args[i]) for i in diff])
    for i, g, w in zip(diff, got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=f"{key}: d argument {i}")
