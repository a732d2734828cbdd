"""High-level API of the port: ``Model`` and its callbacks."""
from . import callbacks
from .callbacks import Callback
from .model import Model

__all__ = ["Model", "Callback", "callbacks"]
