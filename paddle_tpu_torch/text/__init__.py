"""``paddle.text`` (counterpart of ``paddle_tpu/text``): Viterbi decoding
and the dataset names.

:func:`viterbi_decode` is the JAX package's dynamic program (a
``lax.scan`` there) as a loop over the time steps, vectorized over the
batch and the tags on the potentials' device: the scores are
differentiable in the potentials and the transitions, the paths are
int64 and 0 past each sequence's length. The datasets of the reference
(``Conll05st``, ``Imdb``, ``Imikolov``, ``Movielens``, ``UCIHousing``,
``WMT14``, ``WMT16``) download their corpora; each raises, as in the JAX
package, since nothing here downloads.
"""
from __future__ import annotations

import torch

from ..framework.place import to_torch_device
from ..nn.layer.layers import Layer

__all__ = ["viterbi_decode", "ViterbiDecoder", "Conll05st", "Imdb",
           "Imikolov", "Movielens", "UCIHousing", "WMT14", "WMT16"]


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """The highest-scoring tag path: ``potentials [B, T, N]``,
    ``transition_params [N, N]``, ``lengths [B]``. Returns ``(scores
    [B], paths [B, T])``. With ``include_bos_eos_tag`` the last tag is
    BOS (its transition row scores the first step) and the one before it
    EOS (its column scores the exit). Tensors stay on their device; other
    inputs go to the current place (the card unless
    ``set_device("cpu")``)."""
    pot = potentials if isinstance(potentials, torch.Tensor) else \
        torch.as_tensor(potentials, device=to_torch_device(None))
    trans = torch.as_tensor(transition_params, device=pot.device)
    lens = torch.as_tensor(lengths, device=pot.device).to(torch.int64)
    n = pot.shape[2]
    alpha = pot[:, 0] + trans[-1][None, :] if include_bos_eos_tag \
        else pot[:, 0]
    tags = torch.arange(n, device=pot.device)[None, :]
    bps = []
    for step in range(1, pot.shape[1]):
        m = alpha[:, :, None] + trans[None, :, :]          # [B, N, N]
        best_prev = torch.argmax(m, dim=1)                 # [B, N]
        active = (step < lens)[:, None]
        # a sequence past its length keeps its alpha
        alpha = torch.where(active, m.amax(dim=1) + pot[:, step], alpha)
        bps.append(torch.where(active, best_prev, tags))
    if include_bos_eos_tag:
        alpha = alpha + trans[:, -2][None, :]
    scores = alpha.amax(dim=-1)
    path = [torch.argmax(alpha, dim=-1)]
    for bp in reversed(bps):
        path.append(torch.gather(bp, 1, path[-1][:, None])[:, 0])
    paths = torch.stack(path[::-1], dim=1)
    pos = torch.arange(paths.shape[1], device=pot.device)[None, :]
    paths = torch.where(pos < lens[:, None], paths, torch.zeros_like(paths))
    return scores, paths.to(torch.int64)


class ViterbiDecoder(Layer):
    """:func:`viterbi_decode` as a layer over fixed ``transitions``."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        super().__init__()
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)


class _DownloadDataset:
    """The reference's download-driven text datasets: each raises."""

    URL = None

    def __init__(self, *args, **kwargs):
        raise RuntimeError(
            f"{type(self).__name__} downloads its corpus from "
            f"{self.URL or 'a public mirror'}; this environment has no "
            "network egress. Place the archive locally and load it with "
            "paddle_tpu_torch.io.Dataset directly, or run in a connected "
            "environment.")


class Conll05st(_DownloadDataset):
    URL = "https://dataset.bj.bcebos.com/conll05st/conll05st-tests.tar.gz"


class Imdb(_DownloadDataset):
    URL = "https://dataset.bj.bcebos.com/imdb%2FaclImdb_v1.tar.gz"


class Imikolov(_DownloadDataset):
    URL = "https://dataset.bj.bcebos.com/imikolov%2Fsimple-examples.tgz"


class Movielens(_DownloadDataset):
    URL = "https://dataset.bj.bcebos.com/movielens%2Fml-1m.zip"


class UCIHousing(_DownloadDataset):
    URL = "https://archive.ics.uci.edu/ml/machine-learning-databases/housing/"


class WMT14(_DownloadDataset):
    URL = "http://paddlemodels.bj.bcebos.com/wmt/wmt14.tgz"


class WMT16(_DownloadDataset):
    URL = "http://paddlemodels.bj.bcebos.com/wmt/wmt16.tar.gz"
