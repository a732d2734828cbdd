"""Include and library directories for building against the port
(counterpart of ``paddle_tpu/sysconfig.py``): the CUDA and C sources of
its kernels, and the directory their built libraries go to."""
import os

__all__ = ["get_include", "get_lib"]

_ROOT = os.path.dirname(os.path.abspath(__file__))


def get_include():
    """The directory of the kernels' sources and headers (``csrc``)."""
    return os.path.join(_ROOT, "csrc")


def get_lib():
    """The directory of the built kernel libraries (``ops._build``'s,
    ``build/paddle_tpu_torch`` in the checkout unless
    ``PADDLE_TPU_TORCH_BUILD_DIR`` moves it)."""
    from .ops._build import build_dir
    return str(build_dir())
