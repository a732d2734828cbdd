"""High-level training API (counterpart of ``paddle_tpu/hapi/model.py``):
``Model(network).prepare(optimizer, loss, amp_configs=...)`` then
``fit(train_data, ...)``.

``Model`` runs on the card unless the caller passes ``device="cpu"``: it
moves the network there (the same ``Parameter`` objects, so an optimizer
built over them earlier still holds them) and each batch with it.

The JAX ``fit`` dispatches a donated, jitted functional step
(``opt.apply_gradients``). The port's is eager: per batch it runs the
forward and the loss (under ``amp.auto_cast`` when ``amp_configs`` asks
for it), ``loss.backward()``, ``optimizer.step()`` — which launches the
fused AdamW kernel per parameter — and ``optimizer.clear_grad()``. The
AdamW arithmetic is the same. As there, the loss stays on the device
and is read back only every ``log_freq`` steps and at the end of an
epoch.

A batch of ``n`` tensors feeds the network its first ``len(inputs)``
(one less than ``n`` by default) and passes the rest to the loss as
labels; the loss gets ``(*outputs, *labels)``. A network that returns
its own loss (``GPTForPretraining`` fed ``(ids, labels)``) takes
``inputs`` of length 2 and a loss that picks it, e.g.
``loss=lambda loss, logits: loss``.

Ported from ``fit``: epochs, batch_size, shuffle, drop_last, log_freq,
verbose (through ``ProgBarLogger``), callbacks, num_workers and
``amp_configs`` at level ``"O2"`` (the only AMP level ported).
Evaluation, prediction, metrics, save/load, static mode, prefetch,
analysis, numerics, ZeRO and gradient-exchange options wait (ROADMAP).
"""
from __future__ import annotations

import contextlib

import torch

from .. import amp
from .._device import resolve_device
from ..io import DataLoader
from .callbacks import config_callbacks

__all__ = ["Model"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None, device=None):
        self.device = resolve_device(device)
        self.network = network.to(self.device)
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        self._optimizer = None
        self._loss = None
        self._amp = False
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """``amp_configs``: ``"O2"`` or ``{"level": "O2", "dtype":
        "bfloat16"}`` casts the network to bf16 and runs each step under
        ``amp.auto_cast``; any other level or dtype raises."""
        if metrics:
            raise NotImplementedError(
                "metrics are not ported yet: prepare(optimizer, loss)")
        self._optimizer = optimizer
        self._loss = loss
        if amp_configs:
            if isinstance(amp_configs, str):
                level, dtype = amp_configs, "bfloat16"
            else:
                level = amp_configs.get("level", "O1")
                dtype = amp_configs.get("dtype", "bfloat16")
            amp.decorate(self.network, level=level, dtype=dtype)
            self._amp = True
        return self

    def _maybe_amp(self):
        return amp.auto_cast() if self._amp else contextlib.nullcontext()

    def _split_batch(self, batch):
        batch = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        n_in = len(self._inputs) if self._inputs else max(1, len(batch) - 1)
        return batch[:n_in], batch[n_in:]

    def _train_step(self, inputs, labels):
        """One eager step; returns the loss as a device scalar."""
        if self._loss is None:
            raise RuntimeError(
                "no loss configured: call model.prepare(optimizer, loss) "
                "before fit/train_batch")
        inputs = [torch.as_tensor(t).to(self.device, non_blocking=True)
                  for t in inputs]
        labels = [torch.as_tensor(t).to(self.device, non_blocking=True)
                  for t in labels]
        with self._maybe_amp():
            outputs = self.network(*inputs)
            outs = outputs if isinstance(outputs, (list, tuple)) \
                else [outputs]
            loss = self._loss(*outs, *labels)
        loss.backward()
        self._optimizer.step()
        self._optimizer.clear_grad()
        return loss.detach()

    def train_batch(self, inputs, labels=None):
        """One optimizer step on one batch; returns the loss as a float."""
        self.network.train()
        return float(self._train_step(_to_list(inputs), _to_list(labels)))

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            log_freq=10, verbose=2, drop_last=False, shuffle=True,
            num_workers=0, callbacks=None):
        """Train over ``train_data`` (a ``Dataset`` or an iterable of
        batches) for ``epochs`` epochs."""
        if eval_data is not None:
            raise NotImplementedError(
                "evaluation during fit is not ported yet: pass "
                "eval_data=None")
        if isinstance(train_data, torch.utils.data.Dataset):
            loader = DataLoader(train_data, batch_size=batch_size,
                                shuffle=shuffle, drop_last=drop_last,
                                num_workers=num_workers)
        else:
            loader = train_data
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, log_freq=log_freq,
                                verbose=verbose)
        self.stop_training = False
        self.network.train()
        cbks.on_train_begin()
        try:
            for epoch in range(epochs):
                if self.stop_training:
                    break
                cbks.on_epoch_begin(epoch)
                logs, last = {}, None
                for step, batch in enumerate(loader):
                    cbks.on_train_batch_begin(step)
                    last = self._train_step(*self._split_batch(batch))
                    if log_freq > 0 and step % log_freq == 0:
                        logs = {"loss": float(last)}
                    cbks.on_train_batch_end(step, logs)
                if last is not None:
                    logs = {"loss": float(last)}
                cbks.on_epoch_end(epoch, logs)
            cbks.on_train_end()
        except BaseException:
            cbks.on_train_abort()
            raise

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)
