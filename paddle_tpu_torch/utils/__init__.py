"""``utils`` (counterpart of ``paddle_tpu/utils``): the C++ extension
toolchain, :mod:`.cpp_extension` (which builds the C inference API).

The JAX package's other utilities (``unique_name``, ``deprecated``,
``try_import``, ``dlpack``, ``download``, ``require_version``,
``run_check``, and its ``monitor``/``profiler`` aliases) are not ported
yet (ROADMAP Queue 1 item 5): reaching one raises
``NotImplementedError`` naming it.
"""
from . import cpp_extension  # noqa: F401
from ..ops.registry import not_ported as _not_ported

__all__ = ["cpp_extension"]

_DEFERRED = frozenset(("unique_name", "deprecated", "try_import", "monitor",
                       "profiler", "dlpack", "download", "require_version",
                       "run_check", "pretrained"))


def __getattr__(name):
    if name in _DEFERRED:
        raise _not_ported(f"utils.{name}", 5)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
