"""``fluid.io``: the 1.x save/load entry points WITH the 1.x calling
conventions (counterpart of ``paddle_tpu/fluid/io.py``): executor-first,
a directory, and feed variables named by strings. Aliasing the 2.x
functions directly would bind the arguments wrongly.
"""
from __future__ import annotations

import os

from ..io import DataLoader, Dataset  # noqa: F401

__all__ = ["save_persistables", "load_persistables",
           "save_inference_model", "load_inference_model", "DataLoader",
           "Dataset"]


def _prog(main_program):
    from .. import static
    return main_program or static.default_main_program()


def save_persistables(executor, dirname, main_program=None,
                      filename=None):
    """1.x order: (executor, dirname, main_program)."""
    from .. import static
    os.makedirs(dirname, exist_ok=True)
    static.save(_prog(main_program),
                os.path.join(dirname, filename or "params"))


def load_persistables(executor, dirname, main_program=None,
                      filename=None):
    from .. import static
    static.load(_prog(main_program),
                os.path.join(dirname, filename or "params"))


def save_inference_model(dirname, feeded_var_names, target_vars,
                         executor, main_program=None, **kwargs):
    """1.x convention: feed variables by NAME, into a directory."""
    from .. import static
    prog = _prog(main_program)
    feed_vars = [prog._vars[prog._var_names[n]] if isinstance(n, str)
                 else n for n in feeded_var_names]
    os.makedirs(dirname, exist_ok=True)
    return static.save_inference_model(
        os.path.join(dirname, "model"), feed_vars, target_vars, executor,
        program=prog if prog._nodes else None)


def load_inference_model(dirname, executor, **kwargs):
    """``(predictor, feed names, fetch targets)``; the predictor runs on
    the executor's place."""
    from .. import static
    return static.load_inference_model(os.path.join(dirname, "model"),
                                       executor)
