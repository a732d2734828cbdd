"""Version information (counterpart of ``paddle_tpu/version.py``): the
reference API version the port follows, and this build's CUDA and cuDNN
(``"False"`` where the build has none)."""
import torch

full_version = "2.3.0+cuda"
major = "2"
minor = "3"
patch = "0"
rc = "0"
istaged = True
commit = "paddle_tpu_torch"
with_mkl = "ON" if torch.backends.mkl.is_available() else "OFF"

cuda_version = torch.version.cuda or "False"
xpu_version = "False"


def cuda():
    """The CUDA version torch was built with, or ``"False"``."""
    return cuda_version


def cudnn():
    """cuDNN's version as the reference writes it (``"9.1.0"``), or
    ``"False"``."""
    if not torch.backends.cudnn.is_available():
        return "False"
    v = torch.backends.cudnn.version()
    return f"{v // 10000}.{v // 100 % 100}.{v % 100}" if v >= 10000 \
        else f"{v // 1000}.{v // 100 % 10}.{v % 100}"


def xpu():
    return xpu_version


def show():
    print(f"full_version: {full_version}")
    print(f"commit: {commit}")
    print(f"cuda: {cuda()}")
    print(f"cudnn: {cudnn()}")


def __getattr__(name):
    # read at first use: cuDNN's version loads its library
    if name == "cudnn_version":
        return cudnn()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
