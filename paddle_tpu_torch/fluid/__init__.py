"""``fluid``: the 1.x namespace (counterpart of
``paddle_tpu/fluid/__init__.py``; reference python/paddle/fluid, the 1.x
API surface still shipped in 2.3). Code migrating from the reference
often does ``import paddle.fluid as fluid``; this module maps the
commonly used 1.x names onto their 2.x homes so such code runs, while
new code should use the top-level API.

Coverage: the Program/Executor workflow, places, ParamAttr/initializer,
optimizer, io, dygraph basics, layers (``fluid.layers`` -> ``static.nn``
plus the functional namespace). The fluid internals (core C++ bindings,
IR passes) are absent, as in the JAX package.
"""
from ..framework.place import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace,
)
from ..framework.tensor import Tensor as Variable  # noqa: F401
from ..nn.layer.layers import ParamAttr  # noqa: F401
from ..static import (  # noqa: F401
    Executor, Program, Scope, append_backward, data, default_main_program,
    default_startup_program, global_scope, in_dynamic_mode, program_guard,
    scope_guard,
)
from .. import nn  # noqa: F401
from .. import optimizer  # noqa: F401
from ..nn import initializer  # noqa: F401
from . import backward  # noqa: F401
from . import dygraph  # noqa: F401
from . import framework  # noqa: F401
from . import io  # noqa: F401
from . import layers  # noqa: F401


def cuda_places(device_ids=None):
    from ..static import cuda_places as _cp
    return _cp(device_ids)


def cpu_places(device_count=None):
    from ..static import cpu_places as _cp
    return _cp(device_count)


def is_compiled_with_cuda() -> bool:
    from ..device import is_compiled_with_cuda as _c
    return _c()


def in_dygraph_mode() -> bool:
    return in_dynamic_mode()
