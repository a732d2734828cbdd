"""``incubate.autograd`` (counterpart of
``paddle_tpu/incubate/autograd``): the functional and "prim" autodiff
API over the port's ``autograd`` (``torch.autograd``). torch's autograd
is the primitive layer here, so ``enable_prim`` records a flag that
changes nothing, as in the JAX package, and ``prim2orig`` is a no-op (a
recorded program holds no prim ops)."""
from __future__ import annotations

__all__ = ["enable_prim", "disable_prim", "prim_enabled", "forward_grad",
           "grad", "jvp", "vjp", "Jacobian", "Hessian", "prim2orig"]

_prim = {"enabled": False}


def enable_prim():
    if not _prim["enabled"]:
        import logging
        logging.getLogger("paddle_tpu_torch").info(
            "enable_prim(): torch's autograd IS the primitive layer on this "
            "backend — the flag is recorded for parity but changes no "
            "behavior")
    _prim["enabled"] = True


def disable_prim():
    _prim["enabled"] = False


def prim_enabled() -> bool:
    return _prim["enabled"]


def jvp(func, xs, v=None):
    from ...autograd import jvp as _jvp
    return _jvp(func, xs, v)


def vjp(func, xs, v=None):
    from ...autograd import vjp as _vjp
    return _vjp(func, xs, v)


def forward_grad(outputs_fn, xs, v=None):
    """The forward-mode derivative of ``outputs_fn`` at ``xs`` along
    ``v``."""
    _, tangents = jvp(outputs_fn, xs, v)
    return tangents


def grad(outputs_fn, xs, v=None):
    """The reverse-mode gradients of ``outputs_fn`` at ``xs`` (``v`` the
    cotangent)."""
    _, grads = vjp(outputs_fn, xs, v)
    return grads


def prim2orig(block=None):
    return None


class Jacobian:
    """``J = Jacobian(func, xs)``: ``J[:]`` the whole matrix, ``J[i]``,
    ``J[:, j]`` its rows and columns (``autograd.jacobian``)."""

    def __init__(self, func, xs, is_batched=False):
        from ...autograd import jacobian as _jac
        self._mat = _jac(func, xs)

    def __getitem__(self, idx):
        return self._mat[idx]

    @property
    def shape(self):
        return self._mat.shape

    def numpy(self):
        return self._mat.detach().cpu().numpy()


class Hessian(Jacobian):
    """``Hessian(func, xs)`` of a scalar ``func`` (``autograd.hessian``)."""

    def __init__(self, func, xs, is_batched=False):
        from ...autograd import hessian as _hes
        self._mat = _hes(func, xs)
