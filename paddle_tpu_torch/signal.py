"""``signal`` (counterpart of ``paddle_tpu/signal.py``): ``frame``,
``overlap_add``, ``stft`` and ``istft`` over ``torch.fft``.

Both transforms are the JAX package's bodies, not ``torch.stft``/
``torch.istft``: ``stft`` reflect-pads the signal by ``n_fft // 2`` when
``center`` and centre-pads the window to ``n_fft``; ``istft`` divides the
overlap-added frames by the overlap-added ``win * win`` envelope,
clamped at 1e-11 (``torch.istft`` checks the NOLA condition instead),
and raises for ``onesided`` with ``return_complex``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

__all__ = ["stft", "istft", "frame", "overlap_add"]

#: jnp.pad's mode names as torch's
_PAD_MODES = {"reflect": "reflect", "constant": "constant",
              "edge": "replicate", "wrap": "circular",
              "replicate": "replicate", "circular": "circular"}


def _arr(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Overlapping frames of the last axis: ``[..., T]`` ->
    ``[..., frame_length, num_frames]``."""
    a = _arr(x)
    if axis not in (-1, a.dim() - 1):
        raise NotImplementedError("frame supports the last axis")
    return a.unfold(-1, frame_length, hop_length).transpose(-1, -2)


def _frame_index(frame_length, num, hop_length, device):
    return (torch.arange(frame_length, device=device)[None, :]
            + hop_length * torch.arange(num, device=device)[:, None])


def overlap_add(x, hop_length, axis=-1, name=None):
    """The inverse of :func:`frame`: ``[..., frame_length, num_frames]``
    -> ``[..., frame_length + hop_length * (num_frames - 1)]``, one
    scatter-add over the frames' index matrix."""
    a = _arr(x)
    if axis not in (-1, a.dim() - 1):
        raise NotImplementedError("overlap_add supports the last axis")
    frame_length, num = a.shape[-2], a.shape[-1]
    out_len = frame_length + hop_length * (num - 1)
    frames = a.transpose(-1, -2).reshape(*a.shape[:-2], num * frame_length)
    idx = _frame_index(frame_length, num, hop_length, a.device).reshape(-1)
    out = torch.zeros(*a.shape[:-2], out_len, dtype=a.dtype, device=a.device)
    return out.index_add_(-1, idx, frames)


def _window(window, win_length, n_fft, device):
    if window is None:
        win = torch.ones(win_length, dtype=torch.float32, device=device)
    else:
        win = _arr(window).to(device=device, dtype=torch.float32)
    if win_length < n_fft:      # centre-pad the window to n_fft
        lpad = (n_fft - win_length) // 2
        win = TF.pad(win, (lpad, n_fft - win_length - lpad))
    return win


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False,
         onesided=True, name=None):
    """Short-time Fourier transform: ``[B, T]`` or ``[T]`` ->
    ``[..., n_fft // 2 + 1 (or n_fft), num_frames]`` complex."""
    a = _arr(x)
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    win = _window(window, win_length, n_fft, a.device)
    if center:
        pad = n_fft // 2
        lead = a.shape[:-1]
        flat = a.reshape(-1, 1, a.shape[-1])
        a = TF.pad(flat, (pad, pad), mode=_PAD_MODES[pad_mode]).reshape(
            *lead, a.shape[-1] + 2 * pad)
    framed = frame(a, n_fft, hop_length).transpose(-1, -2) * win
    spec = torch.fft.rfft(framed, dim=-1) if onesided else \
        torch.fft.fft(framed, dim=-1)
    if normalized:
        spec = spec / torch.sqrt(torch.tensor(float(n_fft)))
    return spec.transpose(-1, -2)


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """Inverse STFT normalised by the overlap-added squared window."""
    spec = _arr(x)
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    win = _window(window, win_length, n_fft, spec.device)
    frames = spec.transpose(-1, -2)                      # [..., F, K]
    if normalized:
        frames = frames * torch.sqrt(torch.tensor(float(n_fft)))
    if onesided:
        if return_complex:
            raise ValueError(
                "return_complex=True requires onesided=False (a onesided "
                "spectrum reconstructs a real signal)")
        wave = torch.fft.irfft(frames, n=n_fft, dim=-1)
    else:
        wave = torch.fft.ifft(frames, dim=-1)
        if not return_complex:
            wave = wave.real
    wave = wave * win                                    # [..., F, n_fft]
    out = overlap_add(wave.transpose(-1, -2), hop_length)
    env = overlap_add((win * win)[:, None].expand(n_fft, frames.shape[-2]),
                      hop_length)
    out = out / torch.clamp_min(env, 1e-11)
    if center:
        pad = n_fft // 2
        out = out[..., pad:out.shape[-1] - pad]
    if length is not None:
        out = out[..., :length]
    return out
