"""``fluid.framework`` as a real submodule (counterpart of
``paddle_tpu/fluid/framework.py``), so that the common 1.x import style
``from paddle.fluid.framework import ...`` works."""
from ..framework.tensor import Parameter, Tensor as Variable  # noqa: F401
from ..static import (  # noqa: F401
    Program, default_main_program, default_startup_program,
    in_dynamic_mode, program_guard,
)


def in_dygraph_mode() -> bool:
    return in_dynamic_mode()
