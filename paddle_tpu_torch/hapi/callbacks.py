"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``): the
``Callback`` base, the ``CallbackList`` that ``Model.fit`` dispatches to,
and the progress printer ``fit(verbose=...)`` adds.

As in the JAX package, ``fit`` reads the loss back to the host only
every ``log_freq`` steps and at the end of an epoch, so the ``logs`` an
``on_train_batch_end`` receives hold the last values read.
"""
from __future__ import annotations

import time

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "config_callbacks"]


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
        """Teardown when fit raises; errors here never mask the training
        error."""

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
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
        """Every callback's abort hook runs, even if an earlier one
        raises."""
        for c in self.callbacks:
            try:
                c.on_train_abort()
            except Exception:
                pass


class ProgBarLogger(Callback):
    """Prints the step logs every ``log_freq`` steps (``verbose=2``) and
    each epoch's last logs (``verbose>=1``)."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    @staticmethod
    def _fmt(logs):
        return " - ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                          else f"{k}: {v}" for k, v in (logs or {}).items())

    def on_epoch_begin(self, epoch, logs=None):
        self._start = time.time()
        if self.verbose and self.params.get("epochs"):
            print(f"Epoch {epoch + 1}/{self.params['epochs']}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and self.log_freq > 0 \
                and step % self.log_freq == 0:
            steps = self.params.get("steps")
            total = f"/{steps}" if steps else ""
            print(f"step {step}{total} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"Epoch {epoch + 1} done in {time.time() - self._start:.1f}s"
                  f" - {self._fmt(logs)}")


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=2, verbose=2):
    cbks = list(callbacks or [])
    if verbose and not any(isinstance(c, ProgBarLogger) for c in cbks):
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    clist = CallbackList(cbks)
    clist.set_model(model)
    clist.set_params({"epochs": epochs, "steps": steps, "verbose": verbose})
    return clist
