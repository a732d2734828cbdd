"""Framework services of the port: dtypes (:mod:`.dtypes`), places and
the default device (:mod:`.place`), flags (:mod:`.flags`), counters
(:mod:`.monitor`), the error types (:mod:`.enforce`), tensors
(:mod:`.tensor`), ``call_op`` (:mod:`.dispatch`) and seeded random
streams (:mod:`.random`)."""
from . import dispatch, dtypes, enforce, flags, monitor, place, random, tensor
from .random import seed

__all__ = ["dispatch", "dtypes", "enforce", "flags", "monitor", "place",
           "random", "tensor", "seed"]
