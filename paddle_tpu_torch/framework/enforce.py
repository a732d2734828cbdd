"""The Paddle error types (counterpart of
``paddle_tpu/framework/enforce.py``): each is a ``RuntimeError`` and, where
Python has a matching built-in, that too, so ``except ValueError`` catches
an ``InvalidArgumentError``."""
from __future__ import annotations

__all__ = ["EnforceNotMet", "InvalidArgumentError", "NotFoundError",
           "OutOfRangeError", "AlreadyExistsError",
           "PreconditionNotMetError", "UnimplementedError",
           "UnavailableError"]


class EnforceNotMet(RuntimeError):
    """Base of the Paddle error types."""


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class NotFoundError(EnforceNotMet, KeyError):
    pass


class OutOfRangeError(EnforceNotMet, IndexError):
    pass


class AlreadyExistsError(EnforceNotMet):
    pass


class PreconditionNotMetError(EnforceNotMet):
    pass


class UnimplementedError(EnforceNotMet, NotImplementedError):
    pass


class UnavailableError(EnforceNotMet):
    pass
