"""``dataset`` (counterpart of ``paddle_tpu/dataset/``): the legacy
reader-style datasets. Each module's ``train()``/``test()`` (or the
module's own names) returns a reader creator whose calls yield samples,
as the JAX package's do. The package fetches nothing: the readers read
archives under ``common.DATA_HOME`` (``PADDLE_DATA_HOME``, else
``~/.cache/paddle/dataset``) or the paths given, and ``common.download``
raises, naming the path to place a missing file at. ``mnist`` and
``cifar`` read through the port's ``vision.datasets``.
"""
from . import common  # noqa: F401
from . import mnist  # noqa: F401
from . import cifar  # noqa: F401
from . import uci_housing  # noqa: F401
from . import imdb  # noqa: F401
from . import imikolov  # noqa: F401
from . import movielens  # noqa: F401
from . import flowers  # noqa: F401
from . import wmt14  # noqa: F401
from . import wmt16  # noqa: F401
from . import conll05  # noqa: F401
from . import voc2012  # noqa: F401

__all__ = ["common", "mnist", "cifar", "uci_housing", "imdb", "imikolov",
           "movielens", "flowers", "wmt14", "wmt16", "conll05", "voc2012"]
