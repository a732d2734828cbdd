"""Framework services of the port: seeded random streams
(:mod:`.random`)."""
from . import random
from .random import seed

__all__ = ["random", "seed"]
