"""High-level training API (counterpart of ``paddle_tpu/hapi/model.py``):
``Model(network).prepare(optimizer, loss, metrics, amp_configs)``, then
``fit``, ``evaluate``, ``predict``, ``save`` and ``load``.

``Model`` runs on the card unless the caller passes ``device="cpu"``: it
moves the network there (the same ``Parameter`` objects, so an optimizer
built over them earlier still holds them) and each batch with it.

The JAX ``fit`` dispatches a donated, jitted functional step
(``opt.apply_gradients``). The port's is eager: per batch it runs the
forward and the loss (under ``amp.auto_cast`` when ``amp_configs`` asks
for it), ``loss.backward()``, ``optimizer.step()`` — gradient clip,
per-parameter learning rate and the update, the fused AdamW kernel per
parameter for Adam and AdamW — and ``optimizer.clear_grad()``. As there,
``fit`` applies no loss scaling, also in float16 (dynamic scaling is the
eager loop's ``amp.GradScaler``), and the loss stays on the device and
is read back only every ``log_freq`` steps and at the end of an epoch;
with metrics the outputs are read each step, to update them.

A batch of ``n`` tensors feeds the network its first ``len(inputs)``
(one less than ``n`` by default) and passes the rest to the loss and the
metrics as labels; the loss gets ``(*outputs, *labels)``. A network that
returns its own loss (``GPTForPretraining`` fed ``(ids, labels)``) takes
``inputs`` of length 2 and a loss that picks it, e.g.
``loss=lambda loss, logits: loss``.

``fit``'s callback order is the JAX package's: per epoch
``on_epoch_begin``, the batches, ``on_epoch_end`` (``ModelCheckpoint``
saves ``save_dir/<epoch>``), then every ``eval_freq`` epochs an
``evaluate`` whose ``on_eval_end`` reaches ``EarlyStopping`` and
``ReduceLROnPlateau``; ``on_train_end`` saves ``save_dir/final``.
``save(path)`` writes ``path.pdparams`` and ``path.pdopt`` in the JAX
package's format (``framework/io.py``).

Not ported, each raising ``NotImplementedError`` that names its ROADMAP
item: ``save(training=False)``, ``summary``, static mode,
``fit(prefetch=, analyze=)``, ``evaluate(prefetch=)`` and
``train_batch(update=False)`` (Queue 1 item 5), ``fit(numerics=)``
(item 3), ``fit(zero=, grad_comm=)`` (item 4).

``eval_batch``/``evaluate`` give the loss only for batches with labels,
as the JAX package does: under an ``inputs``-only spec (GPT, which takes
its labels among its inputs and returns its loss) the loss is 0.0, and
the network's own loss is the first of ``predict``'s outputs.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from .. import amp
from .._device import resolve_device
from ..framework.io import load as _load
from ..framework.io import save as _save
from ..io import DataLoader
from ..metric import Metric
from .callbacks import config_callbacks

__all__ = ["Model"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item {item})")


class Model:
    def __init__(self, network, inputs=None, labels=None, device=None):
        self.device = resolve_device(device)
        self.network = network.to(self.device)
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._amp_level = "O0"
        self._amp_dtype = "bfloat16"
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """``metrics``: ``metric.Metric`` instances. ``amp_configs``:
        ``"O1"``/``"O2"`` or ``{"level": ..., "dtype": "bfloat16" |
        "float16"}`` (level O1 by default): each step runs under
        ``amp.auto_cast``, and at O2 the network is cast to the AMP dtype
        once; an unknown level or dtype raises ``ValueError``."""
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metrics must be paddle_tpu_torch.metric."
                                f"Metric, got {type(m)}")
        if amp_configs:
            if isinstance(amp_configs, str):
                level, dtype = amp_configs, "bfloat16"
            else:
                level = amp_configs.get("level", "O1")
                dtype = amp_configs.get("dtype", "bfloat16")
            amp.decorate(self.network, level=level, dtype=dtype)
            self._amp_level, self._amp_dtype = level, dtype
        return self

    def _maybe_amp(self):
        if self._amp_level in amp.LEVELS:
            return amp.auto_cast(level=self._amp_level, dtype=self._amp_dtype)
        return contextlib.nullcontext()

    def _split_batch(self, batch, predict=False):
        batch = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        if predict:
            # without an inputs spec, a (sample, label) batch feeds the
            # sample alone
            return batch[:len(self._inputs) or 1], []
        n_in = len(self._inputs) if self._inputs else max(1, len(batch) - 1)
        return batch[:n_in], batch[n_in:]

    def _to_device(self, tensors):
        return [torch.as_tensor(t).to(self.device, non_blocking=True)
                for t in tensors]

    def _forward(self, inputs, labels, with_loss=True):
        """Outputs (a list) and, ``with_loss``, the loss, under the AMP
        policy (``None`` without)."""
        with self._maybe_amp():
            outputs = self.network(*inputs)
            outs = list(outputs) if isinstance(outputs, (list, tuple)) \
                else [outputs]
            loss = self._loss(*outs, *labels) if with_loss else None
        return outs, loss

    def _train_step(self, inputs, labels):
        """One eager step on device tensors; returns the loss as a device
        scalar and the outputs."""
        if self._loss is None:
            raise RuntimeError(
                "no loss configured: call model.prepare(optimizer, loss) "
                "before fit/train_batch")
        outs, loss = self._forward(inputs, labels)
        loss.backward()
        self._optimizer.step()
        self._optimizer.clear_grad()
        return loss.detach(), [o.detach() if torch.is_tensor(o) else o
                               for o in outs]

    def _update_metrics(self, outs, labels):
        results = []
        for m in self._metrics:
            correct = m.compute(*outs, *labels)
            results.append(m.update(*(correct if isinstance(correct, tuple)
                                      else (correct,))))
        return results

    def _pack_logs(self, loss, metrics):
        logs = {"loss": float(loss)}
        for m, r in zip(self._metrics, metrics):
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = r if isinstance(r, list) else [r]
            logs.update({k: float(np.asarray(v).ravel()[0])
                         for k, v in zip(names, vals)})
        return logs

    def _metric_names(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    # -- single batches -----------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True,
                    return_numpy=True):
        """One optimizer step on one batch: the loss as a float (with
        ``return_numpy=False`` a device scalar, read back by nobody), with
        the metrics' results beside it when there are metrics. Every call
        steps: ``update=False`` (gradients without a step) is not ported
        yet (ROADMAP Queue 1 item 5)."""
        if not update:
            raise _not_ported("train_batch(update=False)", 5)
        self.network.train()
        labels = self._to_device(_to_list(labels))
        loss, outs = self._train_step(self._to_device(_to_list(inputs)),
                                      labels)
        metrics = self._update_metrics(outs, labels)
        if return_numpy:
            loss = float(loss)
        return (loss, metrics) if metrics else loss

    def eval_batch(self, inputs, labels=None):
        """The loss of one batch under ``torch.no_grad()`` in eval mode,
        with the metrics' results beside it when there are metrics. The
        loss is computed as in training when the batch has labels; else
        (an ``inputs``-only spec, as GPT's) it is 0.0, and so is it
        without a loss, as in the JAX package's eval step."""
        labels = self._to_device(_to_list(labels))
        was_training = self.network.training
        self.network.eval()
        try:
            with torch.no_grad():
                outs, loss = self._forward(
                    self._to_device(_to_list(inputs)), labels,
                    self._loss is not None and bool(labels))
        finally:
            self.network.train(was_training)
        metrics = self._update_metrics(outs, labels)
        loss = 0.0 if loss is None else float(loss)
        return (loss, metrics) if metrics else loss

    def predict_batch(self, inputs):
        """The network's outputs on one batch as numpy arrays, under
        ``torch.no_grad()`` in eval mode (an output that is not a tensor,
        such as GPT's ``None`` logits beside its chunked loss, as
        ``np.asarray`` makes it, as in the JAX package)."""
        was_training = self.network.training
        self.network.eval()
        try:
            with torch.no_grad():
                outs, _ = self._forward(self._to_device(_to_list(inputs)),
                                        [], with_loss=False)
        finally:
            self.network.train(was_training)
        return [np.asarray(o) if not torch.is_tensor(o)
                else o.float().cpu().numpy() if o.is_floating_point()
                else o.cpu().numpy() for o in outs]

    # -- fit / evaluate / predict -------------------------------------------
    def _as_loader(self, data, batch_size, shuffle, num_workers, drop_last):
        if isinstance(data, torch.utils.data.Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers)
        return data

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            prefetch=None, prefetch_buffer_size=2, analyze=None,
            numerics=None, zero=None, grad_comm=None):
        """Train over ``train_data`` (a ``Dataset`` or an iterable of
        batches) for ``epochs`` epochs, evaluating on ``eval_data`` every
        ``eval_freq`` epochs and, with ``save_dir``, checkpointing every
        ``save_freq`` epochs and at the end. ``prefetch_buffer_size``
        sizes ``prefetch``'s buffer, which is not ported."""
        for opt, value, item in (("prefetch", prefetch, 5),
                                 ("analyze", analyze, 5),
                                 ("numerics", numerics, 3),
                                 ("zero", zero, 4),
                                 ("grad_comm", grad_comm, 4)):
            if value not in (None, False, 0, "off", "fp32"):
                raise _not_ported(f"fit({opt}=...)", item)
        loader = self._as_loader(train_data, batch_size, shuffle,
                                 num_workers, drop_last)
        eval_loader = None if eval_data is None else self._as_loader(
            eval_data, batch_size, False, num_workers, False)
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, log_freq=log_freq,
                                verbose=verbose, save_freq=save_freq,
                                save_dir=save_dir,
                                metrics=self._metric_names())
        self.stop_training = False
        self.network.train()
        cbks.on_train_begin()
        try:
            for epoch in range(epochs):
                if self.stop_training:
                    break
                cbks.on_epoch_begin(epoch)
                for m in self._metrics:
                    m.reset()
                logs, last, metrics = {}, None, []
                for step, batch in enumerate(loader):
                    cbks.on_train_batch_begin(step)
                    inputs, labels = (self._to_device(t) for t in
                                      self._split_batch(batch))
                    last, outs = self._train_step(inputs, labels)
                    if self._metrics:
                        metrics = self._update_metrics(outs, labels)
                    if log_freq > 0 and step % log_freq == 0:
                        logs = self._pack_logs(last, metrics)
                    cbks.on_train_batch_end(step, logs)
                if last is not None:
                    logs = self._pack_logs(last, metrics)
                cbks.on_epoch_end(epoch, logs)
                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    self.evaluate(eval_loader, batch_size=batch_size,
                                  verbose=verbose, callbacks=cbks,
                                  _inside_fit=True)
            cbks.on_train_end()
        except BaseException:
            cbks.on_train_abort()
            raise

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, prefetch=None,
                 _inside_fit=False):
        """The mean of the batches' losses (``"loss"``, 0.0 for batches
        without labels) and each metric's accumulated value over
        ``eval_data``."""
        if prefetch not in (None, False, 0):
            raise _not_ported("evaluate(prefetch=...)", 5)
        loader = self._as_loader(eval_data, batch_size, False, num_workers,
                                 False)
        for m in self._metrics:
            m.reset()
        cbks = callbacks if _inside_fit else config_callbacks(
            callbacks, model=self, verbose=verbose,
            metrics=self._metric_names())
        cbks.on_eval_begin()
        total_loss, n = 0.0, 0
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            result = self.eval_batch(*self._split_batch(batch))
            loss, metrics = result if isinstance(result, tuple) \
                else (result, [])
            total_loss += loss
            n += 1
            cbks.on_eval_batch_end(step, self._pack_logs(loss, metrics))
        logs = {"loss": total_loss / max(1, n)}
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = m.accumulate()
            vals = vals if isinstance(vals, list) else [vals]
            logs.update(dict(zip(names, vals)))
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """The outputs over ``test_data``: one list per output of the
        network, holding each batch's numpy array, or with
        ``stack_outputs`` one array concatenated over the batches."""
        loader = self._as_loader(test_data, batch_size, False, num_workers,
                                 False)
        outputs = [self.predict_batch(self._split_batch(b, predict=True)[0])
                   for b in loader]
        if not outputs:
            return []
        grouped = [[b[i] for b in outputs] for i in range(len(outputs[0]))]
        if stack_outputs:
            grouped = [np.concatenate(g) for g in grouped]
        return grouped

    # -- persistence --------------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (the network's ``state_dict``) and, with an
        optimizer, ``path.pdopt`` (its ``state_dict``)."""
        if not training:
            raise _not_ported("save(training=False) (the inference export)",
                              5)
        _save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Parameters from ``path.pdparams`` (cast to the network's dtypes
        and device); with ``skip_mismatch``, keys the network lacks or
        whose shapes differ are left out instead of raising. Then, unless
        ``reset_optimizer``, the optimizer's state from ``path.pdopt``
        when that file exists."""
        state = _load(path + ".pdparams")
        if skip_mismatch:
            own = self.network.state_dict()
            state = {k: v for k, v in state.items()
                     if k in own and tuple(v.shape) == tuple(own[k].shape)}
        self.network.load_state_dict(state, strict=not skip_mismatch)
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path):
            self._optimizer.set_state_dict(_load(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        raise _not_ported("Model.summary", 5)
