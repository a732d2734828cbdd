"""Framework services of the port: dtypes (:mod:`.dtypes`), places and
the default device (:mod:`.place`), flags (:mod:`.flags`), counters
(:mod:`.monitor`), the error types (:mod:`.enforce`), tensors
(:mod:`.tensor`), ``call_op`` (:mod:`.dispatch`), seeded random
streams (:mod:`.random`) and ``save``/``load`` (:mod:`.io`)."""
from . import (dispatch, dtypes, enforce, flags, io, monitor, place, random,
               tensor)
from .io import load, save
from .random import seed

__all__ = ["dispatch", "dtypes", "enforce", "flags", "io", "monitor",
           "place", "random", "tensor", "load", "save", "seed"]
