"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``): the
``Callback`` base with its train, eval and predict hooks, the
``CallbackList`` that ``Model`` dispatches to, and the callbacks
``ProgBarLogger``, ``ModelCheckpoint``, ``EarlyStopping``,
``LRScheduler``, ``History``, ``VisualDL`` and ``ReduceLROnPlateau``.

As in the JAX package, ``fit`` reads the loss back to the host only
every ``log_freq`` steps and at the end of an epoch, so the ``logs`` an
``on_train_batch_end`` receives hold the last values read.
``config_callbacks`` always appends ``LRScheduler()`` and ``History()``
(the first steps an ``LRScheduler`` learning rate once a batch), and a
``ModelCheckpoint`` when ``fit`` is given a ``save_dir``.
``ProfilerCallback`` raises: the span profiler it drives is not ported
(ROADMAP Queue 1 item 3).
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from ..optimizer.lr import LRScheduler as Sched

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "ReduceLROnPlateau", "LRScheduler", "History",
           "VisualDL", "ProfilerCallback", "config_callbacks"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_train_abort(self):
        """Teardown when fit raises: release resources/global state
        WITHOUT the success-path side effects of on_train_end. Exceptions
        raised here are swallowed by Model.fit so they can never mask the
        training error."""
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatch(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return dispatch
        raise AttributeError(name)

    def on_train_abort(self):
        """Error-isolated teardown fan-out (unlike the generic on_*
        dispatch): when fit fails, EVERY callback's abort hook runs even
        if an earlier one raises, so e.g. ProfilerCallback's armed global
        session is always released."""
        for c in self.callbacks:
            try:
                c.on_train_abort()
            except Exception:
                pass


class ProgBarLogger(Callback):
    """Prints the step logs every ``log_freq`` steps (``verbose=2``), each
    epoch's last logs and the evaluation's (``verbose>=1``): every key,
    0-d tensors formatted like floats."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._start = time.time()
        if self.verbose and self.params.get("epochs"):
            print(f"Epoch {epoch + 1}/{self.params['epochs']}")

    def _fmt(self, logs):
        parts = []
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple, np.ndarray)):
                parts.append(f"{k}: {np.asarray(v).ravel()}")
            elif isinstance(v, float):
                parts.append(f"{k}: {v:.4f}")
            elif getattr(v, "ndim", None) == 0:
                # a 0-d tensor prints as a float (fit's own logs are
                # floats already); ints and bools keep their format
                try:
                    parts.append(f"{k}: {float(v):.4f}")
                except (TypeError, ValueError):
                    parts.append(f"{k}: {v}")
            else:
                parts.append(f"{k}: {v}")
        return " - ".join(parts)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and step % self.log_freq == 0:
            total = f"/{self.steps}" if self.steps else ""
            print(f"step {step}{total} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._start
            print(f"Epoch {epoch + 1} done in {dt:.1f}s - "
                  f"{self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    """``model.save(save_dir/<epoch>)`` every ``save_freq`` epochs, and
    ``save_dir/final`` when training ends."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model is not None and \
                epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir and self.model is not None:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    """Sets ``model.stop_training`` once the evaluation's ``monitor`` has
    not improved by ``min_delta`` for ``patience`` evaluations."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.monitor_op = np.greater
            self.min_delta *= 1
        else:
            self.monitor_op = np.less
            self.min_delta *= -1
        self.best = None
        self.wait = 0
        self.stopped_epoch = 0

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = self.baseline

    def on_eval_end(self, logs=None):
        current = (logs or {}).get(self.monitor)
        if current is None:
            return
        current = float(np.asarray(current).ravel()[0])
        if self.best is None or self.monitor_op(
                current - self.min_delta, self.best):
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping: no {self.monitor} improvement "
                          f"for {self.patience} evals")


class LRScheduler(Callback):
    """Steps the optimizer's ``LRScheduler`` after every batch
    (``by_step``) and/or every epoch (``by_epoch``)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


class History(Callback):
    def on_train_begin(self, logs=None):
        self.history = {}

    def on_epoch_end(self, epoch, logs=None):
        for k, v in (logs or {}).items():
            self.history.setdefault(k, []).append(v)


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=2, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    if not any(isinstance(c, History) for c in cbks):
        cbks.append(History())
    clist = CallbackList(cbks)
    clist.set_model(model)
    clist.set_params({
        "epochs": epochs, "steps": steps, "verbose": verbose,
        "metrics": metrics or [],
    })
    return clist


class VisualDL(Callback):
    """Scalar logging: the JAX package's JSONL records under ``log_dir``
    (``scalars.jsonl``, one ``{"tag", "step", "value"}`` a scalar):
    ``train/<key>`` each batch, ``epoch/<key>`` each epoch,
    ``eval/<key>`` after each evaluation."""

    def __init__(self, log_dir="./vdl_log"):
        super().__init__()
        self.log_dir = log_dir
        self._fh = None
        self._step = 0

    def _write(self, tag, value, step):
        if self._fh is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._fh = open(
                os.path.join(self.log_dir, "scalars.jsonl"), "a")
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        self._fh.write(json.dumps(
            {"tag": tag, "step": int(step), "value": v}) + "\n")

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        for k, v in (logs or {}).items():
            self._write(f"train/{k}", v, self._step)

    def on_epoch_end(self, epoch, logs=None):
        for k, v in (logs or {}).items():
            self._write(f"epoch/{k}", v, epoch)
        if self._fh is not None:
            self._fh.flush()

    def on_eval_end(self, logs=None):
        for k, v in (logs or {}).items():
            self._write(f"eval/{k}", v, self._step)
        if self._fh is not None:
            self._fh.flush()

    def on_train_end(self, logs=None):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def on_train_abort(self):
        self.on_train_end()   # flush+close is safe teardown either way


class ReduceLROnPlateau(Callback):
    """Shrink the lr when the monitored evaluation log plateaus, through
    the optimizer's ``set_lr`` (which raises for an ``LRScheduler`` lr,
    as in the JAX package)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = float(factor)
        if self.factor >= 1.0:
            raise ValueError("factor must be < 1.0")
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.monitor_op = np.greater
        else:
            self.monitor_op = np.less
            self.min_delta = -self.min_delta
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def on_train_begin(self, logs=None):
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def _current(self, logs):
        v = (logs or {}).get(self.monitor)
        return None if v is None else float(np.asarray(v).ravel()[0])

    def on_eval_end(self, logs=None):
        current = self._current(logs)
        if current is None:
            return
        in_cooldown = self.cooldown_counter > 0
        if in_cooldown:
            self.cooldown_counter -= 1
            self.wait = 0
        if self.best is None or self.monitor_op(
                current - self.min_delta, self.best):
            self.best = current
            self.wait = 0
            return
        if in_cooldown:
            return            # frozen: stagnation doesn't count yet
        self.wait += 1
        if self.wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is None:
                return
            old = float(opt.get_lr())
            new = max(old * self.factor, self.min_lr)
            if new < old:
                opt.set_lr(new)
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr {old:.3g} -> {new:.3g}")
            self.cooldown_counter = self.cooldown
            self.wait = 0


class ProfilerCallback(Callback):
    """Not ported: it drives the span profiler (``profiler/``), which
    waits for ROADMAP Queue 1 item 3."""

    def __init__(self, start_step=1, stop_step=4, chrome_trace_path=None,
                 prometheus_path=None, summary=True, verbose=1):
        raise NotImplementedError("ProfilerCallback is not ported yet "
                                  "(ROADMAP Queue 1 item 3)")
