"""The Paddle-only members of the JAX ``Tensor`` on the port's tensors.

The port's tensor is ``torch.Tensor``; importing the port installs
``stop_gradient`` (get and set), ``place``, ``clear_grad``/
``clear_gradient`` and ``_rebind`` on it, only names torch lacks. Each is
held to the JAX ``Tensor`` on the same sequence of calls:

* ``stop_gradient`` on leaves (float and integer) and on a non-leaf, and
  the gradients that then flow (a non-leaf keeps passing its gradient,
  as the JAX tape does);
* ``place`` is the tensor's own device as a port ``Place``;
* ``clear_grad``/``clear_gradient`` drop the gradient;
* ``_rebind`` (the primitive of the JAX ``setitem`` and ``*_`` ops): the
  gradients of an in-place ``where``-update and of ``tanh_``/``scale_``
  chains against the JAX package's, within 1e-6; a leaf that requires
  grad cannot take over a value with a graph (the JAX error);
* importing the port changes no attribute ``torch.Tensor`` had (checked
  in a fresh interpreter), and the installer refuses a name torch has.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.enforce import PreconditionNotMetError as JaxError
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import tensor as ttensor
from paddle_tpu_torch.framework.enforce import PreconditionNotMetError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = np.array([0.5, -1.0, 2.0, 0.25], np.float32)
V = np.array([1.5, -0.5, 0.75, 3.0], np.float32)
C = np.array([1.0, 2.0, -3.0, 0.5], np.float32)
MASK = np.array([False, True, True, False])


def test_stop_gradient_on_leaves_matches_jax():
    j = paddle.to_tensor(W)
    t = torch.from_numpy(W.copy())
    assert t.stop_gradient is j.stop_gradient is True
    j.stop_gradient = False
    t.stop_gradient = False
    assert t.stop_gradient is j.stop_gradient is False
    assert t.requires_grad
    ji = paddle.to_tensor(np.arange(3))
    ti = torch.arange(3)
    ji.stop_gradient = False
    ti.stop_gradient = False        # torch cannot mark an int tensor
    assert ti.stop_gradient is ji.stop_gradient is False
    assert not ti.requires_grad
    t.stop_gradient = True
    assert t.stop_gradient and not t.requires_grad


def test_stop_gradient_on_a_non_leaf_keeps_the_graph_as_jax():
    def run(P, arr):
        w = arr(W)
        w.stop_gradient = False
        y = w * 3.0
        first = y.stop_gradient
        y.stop_gradient = True
        loss = (y * arr(C)).sum()
        loss.backward()
        return first, y.stop_gradient, np.asarray(w.grad.numpy())

    jf, js, jg = run(paddle, paddle.to_tensor)
    tf, ts, tg = run(pt, lambda a: torch.from_numpy(a.copy()))
    assert (tf, ts) == (jf, js) == (False, True)
    np.testing.assert_allclose(tg, jg, atol=1e-6)


def test_place_is_the_tensor_device():
    t = torch.zeros(2)
    assert t.place == pt.CPUPlace()
    assert isinstance(t.place, pt.Place)
    assert torch.nn.Parameter(torch.zeros(1)).place == pt.CPUPlace()


@pytest.mark.parametrize("method", ["clear_grad", "clear_gradient"])
def test_clear_grad_drops_the_gradient(method):
    for make in (lambda: paddle.to_tensor(W, stop_gradient=False),
                 lambda: torch.tensor(W, requires_grad=True)):
        x = make()
        (x * 2).sum().backward()
        assert x.grad is not None
        getattr(x, method)()
        assert x.grad is None


def _rebind_run(P, arr, where, tanh, scale):
    """``x = w * 1``; ``x`` takes over ``where(mask, v * 2, x)``, then
    ``tanh(x)`` and ``2 x + 1`` in place; the loss ``sum(x * c)``."""
    w, v = arr(W), arr(V)
    w.stop_gradient = False
    v.stop_gradient = False
    x = w * 1.0
    x._rebind(where(arr(MASK), v * 2.0, x))
    x._rebind(tanh(x))
    x._rebind(scale(x))
    (x * arr(C)).sum().backward()
    return (np.asarray(x.detach().numpy()), np.asarray(w.grad.numpy()),
            np.asarray(v.grad.numpy()))


def test_rebind_gradient_matches_jax():
    want = _rebind_run(paddle, paddle.to_tensor, paddle.where, paddle.tanh,
                       lambda x: paddle.scale(x, 2.0, 1.0))
    got = _rebind_run(pt, lambda a: torch.from_numpy(a.copy()), torch.where,
                      torch.tanh, lambda x: pt.scale(x, 2.0, 1.0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6)
    assert want[1][MASK].tolist() == [0.0, 0.0]


def test_rebind_without_a_graph_takes_the_value():
    for arr in (paddle.to_tensor, lambda a: torch.from_numpy(a.copy())):
        x = arr(W)
        x._rebind(arr(V))
        np.testing.assert_array_equal(np.asarray(x.numpy()), V)
        assert x.stop_gradient


def test_rebind_of_a_leaf_that_requires_grad_raises_as_jax():
    j = paddle.to_tensor(W, stop_gradient=False)
    with pytest.raises(JaxError, match="leaf tensor that requires grad"):
        j._rebind(j * 2.0)
    t = torch.tensor(W, requires_grad=True)
    with pytest.raises(PreconditionNotMetError,
                       match="leaf tensor that requires grad"):
        t._rebind(t * 2.0)


def test_importing_the_port_shadows_nothing_of_torch():
    code = (
        "import torch\n"
        "def members():\n"
        "    out = {}\n"
        "    for cls in torch.Tensor.__mro__:\n"
        "        for k, v in vars(cls).items():\n"
        "            out.setdefault(k, v)\n"
        "    return out\n"
        "before = members()\n"
        "import paddle_tpu_torch\n"
        "after = members()\n"
        "changed = sorted(k for k in before if after[k] is not before[k])\n"
        "added = sorted(set(after) - set(before))\n"
        "print(changed, added)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"[] {sorted(ttensor._TENSOR_MEMBERS)}"


def test_the_installer_refuses_a_name_torch_has(monkeypatch):
    monkeypatch.setitem(ttensor._TENSOR_MEMBERS, "add", property(len))
    with pytest.raises(RuntimeError, match="already defines 'add'"):
        ttensor.install_tensor_methods()
