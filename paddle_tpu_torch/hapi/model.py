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

Observability, as in the JAX package: ``fit(numerics="record" | "warn"
| "halt")`` (or ``FLAGS_numerics``) audits every step on the device
(``profiler/numerics.py`` ``build_audit``: finite bits, loss, grad,
clipped, parameter and update norms, per-layer-group nonfinite counts),
keeps the vectors on the device and copies them to the host in the same
copy as the loss at the log windows, where the ``NumericsRecorder``
rings them and applies the policy (``halt`` raises ``NumericsError``
after its postmortem). At each window ``hapi/flops_per_sec`` and, with
a known peak, ``hapi/mfu`` are observed from the counted FLOPs of the
steps run (``program_registry.gpt_step_cost``, for GPT networks) and a
memory sample is taken; the train state's bytes are in the memory
ledger (``hapi/state[<net>#<n>]/{params,opt_state,buffers}``), and an
out-of-memory error leaves the memory postmortem before it is
re-raised.

Static mode, as in the JAX package: under ``enable_static()``
``fit``/``evaluate``/``predict`` and the ``*_batch`` calls go through a
``_StaticGraphAdapter``, which captures the network (and the loss, and
the optimizer's ``minimize``) once into ``static.Program``s fed from the
Model's ``InputSpec``s and runs each batch as one ``Executor.run``.
``save(path, training=False)`` exports the network for inference
through ``jit.save(network, path, input_spec=inputs)``, under the AMP
policy of ``prepare``.

Batches reach the device through ``io.device_prefetch`` in ``fit`` and
``evaluate`` (``prefetch=None`` defers to ``FLAGS_hapi_prefetch``, on by
default, as in the JAX package; static mode never prefetches): the copy
of the next batch runs on its own CUDA stream under the current step.
``train_batch(update=False)`` accumulates the gradients into ``.grad``
without a step, as the reference's dygraph adapter does; the next
``update=True`` call steps on their sum and clears them.

Not ported, each raising ``NotImplementedError`` that names its ROADMAP
item: ``fit(analyze=)`` and static-mode ``train_batch(update=False)``
(Queue 1 item 5), ``fit(zero=, grad_comm=)`` (item 4).

``eval_batch``/``evaluate`` give the loss only for batches with labels,
as the JAX package does: under an ``inputs``-only spec (GPT, which takes
its labels among its inputs and returns its loss) the loss is 0.0, and
the network's own loss is the first of ``predict``'s outputs.
"""
from __future__ import annotations

import contextlib
import os
import time
import weakref
from collections import deque

import numpy as np
import torch

from .. import amp
from .._device import resolve_device
from ..framework import program_registry as _registry
from ..framework.io import load as _load
from ..framework.io import save as _save
from ..framework.flags import flag_value
from ..framework.monitor import stat_add, stat_get, stat_observe
from ..io import DataLoader, device_prefetch
from ..metric import Metric
from ..profiler import memory as _memory
from ..profiler import numerics as _numerics
from ..profiler import span as _prof
from .callbacks import config_callbacks

__all__ = ["Model"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item {item})")


def _drop_ledger_keys(keys):
    """weakref.finalize target for a Model's memory-ledger entries — a
    module function so the finalizer holds no reference to the Model."""
    for k in keys:
        _memory.ledger_drop(k)


@contextlib.contextmanager
def _closing(data_iter, loader):
    """``data_iter``; when it is the prefetching generator made over
    ``loader``, closed on the way out, which stops its producer thread at
    once, also when a step raised (the caller's own iterable is left
    open)."""
    try:
        yield data_iter
    finally:
        if data_iter is not loader:
            data_iter.close()


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _StaticGraphAdapter:
    """Routes Model.fit/evaluate/predict through the static
    Program/Executor when ``enable_static()`` is on (the JAX package's
    adapter; the reference's StaticGraphAdapter, hapi/model.py:290).

    The network's forward is captured ONCE into a main Program under
    ``program_guard`` (feeds from the Model's InputSpecs), the loss and
    the optimizer's ``minimize`` are appended, and every train batch is
    one ``Executor.run`` (the replay, ``backward()``, the optimizer's
    step). Eval and predict run a second capture made in eval mode, the
    reference's main/test pair. As in the JAX package, BatchNorm's
    running statistics do not update across static training steps (the
    layer writes them outside the recorded ops)."""

    def __init__(self, model: "Model"):
        self.model = model
        self._built = False

    def _spec_name(self, spec, prefix, i):
        return getattr(spec, "name", None) or f"{prefix}_{i}"

    def _capture(self, program, startup=None, with_optimizer=False):
        from .. import static
        m = self.model
        with static.program_guard(program, startup), m._maybe_amp():
            in_vars = [
                static.data(self._spec_name(s, "input", i),
                            list(s.shape), s.dtype)
                for i, s in enumerate(m._inputs)]
            label_vars = [
                static.data(self._spec_name(s, "label", i),
                            list(s.shape), s.dtype)
                for i, s in enumerate(m._labels)]
            outputs = m.network(*in_vars)
            outs = list(outputs) if isinstance(outputs, (list, tuple)) \
                else [outputs]
            loss = None
            if m._loss is not None and label_vars:
                loss = m._loss(*outs, *label_vars)
                if with_optimizer and m._optimizer is not None:
                    m._optimizer.minimize(loss)
        return loss, outs

    def _build(self):
        from .. import static
        m = self.model
        if not m._inputs or not all(hasattr(s, "shape")
                                    for s in m._inputs + m._labels):
            raise ValueError(
                "static-graph Model requires inputs=[InputSpec(...)] (and "
                "labels=[InputSpec(...)] to train) at construction: feeds "
                "must be declared before the program is built")
        was_training = m.network.training
        main, startup = static.Program(), static.Program()
        try:
            m.network.train()
            self._loss_var, self._out_vars = self._capture(
                main, startup, with_optimizer=True)
            m.network.eval()
            test = static.Program()
            self._test_loss_var, self._test_out_vars = self._capture(test)
        finally:
            m.network.train(was_training)
        self._exe = static.Executor()
        self._main, self._test = main, test
        self._in_names = [self._spec_name(s, "input", i)
                          for i, s in enumerate(m._inputs)]
        self._label_names = [self._spec_name(s, "label", i)
                             for i, s in enumerate(m._labels)]
        self._built = True

    def _feed(self, inputs, labels, need_labels):
        if not self._built:
            self._build()
        if need_labels and self._label_names and not labels:
            raise ValueError(
                f"this batch must include labels for declared feed(s) "
                f"{self._label_names} (the fetched loss depends on them)")
        arrays = list(inputs) + (list(labels) if labels else [])
        names = self._in_names + (self._label_names if labels else [])
        if len(arrays) != len(names):
            raise ValueError(
                f"batch has {len(arrays)} arrays but the static program "
                f"declares {len(names)} feeds ({names})")
        return dict(zip(names, arrays))

    def train_step(self, inputs, labels):
        """One train step: the loss (a device scalar) and the outputs."""
        feed = self._feed(inputs, labels, True)
        if self._loss_var is None:
            raise RuntimeError("no loss/labels declared: static-mode "
                               "training needs labels=[InputSpec] + loss")
        res = self._exe.run(self._main, feed=feed,
                            fetch_list=[self._loss_var] + self._out_vars,
                            return_numpy=False)
        return res[0], res[1:]

    def eval_step(self, inputs, labels):
        """The loss (``None`` without labels) and the outputs."""
        feed = self._feed(inputs, labels, False)
        with_loss = self._test_loss_var is not None and bool(labels)
        fetches = ([self._test_loss_var] if with_loss else []) \
            + self._test_out_vars
        res = self._exe.run(self._test, feed=feed, fetch_list=fetches,
                            return_numpy=False)
        return (res[0], res[1:]) if with_loss else (None, res)


class Model:
    # numerics audit vectors wait on the device between log windows,
    # (6 + groups) f32 each, one a step: with log_freq <= 0 (epoch-end
    # windows only) the newest cap's worth survive to the window (a NaN
    # propagates, so the tail still trips the sentinel), drops counted
    # in hapi/audit_window_dropped
    _AUDIT_WINDOW = 4096
    _seq = 0

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
        self._step_counter = 0          # global steps, 1 at the first
        # achieved FLOP/s over a log window: the counted FLOPs of the
        # steps run since the last window and the window's start stamp
        self._flush_flops = 0.0
        self._flush_steps = 0
        self._flush_t0 = None
        self._step_flops = {}           # input shape -> counted FLOPs
        # numerics health (profiler/numerics.py)
        self._numerics_mode = "off"
        self._audit_layout = None
        self._audit_window = deque(maxlen=self._AUDIT_WINDOW)
        self._audit_collect = False
        self._numerics_recorder = None
        self._retrace_mark = 0.0
        # test hook: the loss times +inf at this global step, so the
        # sentinel path is testable without crafted data
        self._numerics_inject_inf_at = None
        Model._seq += 1
        self._site = f"hapi/train_step[{type(network).__name__}" \
                     f"#{Model._seq}]"
        self._ledger_base = None
        self._static_adapter = None

    def _static(self):
        """The StaticGraphAdapter when ``enable_static()`` is on (the mode
        is sampled per call, like the reference's _run_backend)."""
        from ..static import in_dynamic_mode
        if in_dynamic_mode():
            return None
        if self._static_adapter is None:
            self._static_adapter = _StaticGraphAdapter(self)
        return self._static_adapter

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
        """The batch's tensors on the Model's device: one already there
        (a prefetched batch) is passed on as it is, not copied."""
        return [torch.as_tensor(t).to(self.device, non_blocking=True)
                for t in tensors]

    def _forward(self, inputs, labels, with_loss=True):
        """Outputs (a list) and, ``with_loss``, the loss, under the AMP
        policy (``None`` without); in static mode one run of the test
        program."""
        adapter = self._static()
        if adapter is not None:
            loss, outs = adapter.eval_step(inputs, labels if with_loss
                                           else [])
            return outs, loss
        with self._maybe_amp():
            outputs = self.network(*inputs)
            outs = list(outputs) if isinstance(outputs, (list, tuple)) \
                else [outputs]
            loss = self._loss(*outs, *labels) if with_loss else None
        return outs, loss

    def _train_step(self, inputs, labels, update=True):
        """One eager step on device tensors; returns the loss as a device
        scalar and the outputs. With numerics armed, the step's audit
        vector is queued on the device (read nothing back). Without
        ``update`` the gradients accumulate into ``.grad``: no optimizer
        step, no ``clear_grad``."""
        if self._loss is None:
            raise RuntimeError(
                "no loss configured: call model.prepare(optimizer, loss) "
                "before fit/train_batch")
        adapter = self._static()
        if adapter is not None and not update:
            raise _not_ported("train_batch(update=False) in static mode", 5)
        self._step_counter += 1
        t0 = time.perf_counter()
        if self._flush_t0 is None:
            self._flush_t0 = t0
        self._flush_steps += 1
        self._flush_flops += self._counted_flops(inputs) or 0.0
        audit = update and self._audit_collect and \
            self._audit_layout is not None
        if adapter is not None:
            with _prof.record("hapi/train_batch", "hapi"):
                loss, outs = adapter.train_step(inputs, labels)
            stat_observe("hapi/step_time_ms",
                         (time.perf_counter() - t0) * 1e3)
            return loss, outs
        with _prof.record("hapi/train_batch", "hapi"):
            outs, loss = self._forward(inputs, labels)
            if audit:
                train = self._audit_params()
                olds = {k: p.detach().clone() for k, p in train.items()}
                if self._numerics_inject_inf_at == self._step_counter:
                    loss = loss.float() * float("inf")
            loss.backward()
            if update:
                self._optimizer.step()
                if audit:
                    self._audit(loss, train, olds)
                self._optimizer.clear_grad()
        # the host's time to queue the step (no sync: the card runs on)
        stat_observe("hapi/step_time_ms", (time.perf_counter() - t0) * 1e3)
        return loss.detach(), [o.detach() if torch.is_tensor(o) else o
                               for o in outs]

    # -- numerics audit, counted FLOPs, the memory ledger ---------------------
    def _audit_params(self):
        """The trainable parameters by the network's names (the JAX
        package's tree names)."""
        return {k: p for k, p in self.network.named_parameters()
                if p.requires_grad}

    def _audit(self, loss, train, olds):
        """Queue this step's audit vector (``numerics.build_audit``) on
        the device: the raw gradients (a missing one counts as zeros),
        the parameters before and after the update, and the clip's norms
        where the optimizer kept them."""
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in train.items()}
        pre, post = getattr(self._optimizer, "_clip_norms", None) \
            or (None, None)
        vec = _numerics.build_audit(
            loss, grads, olds, {k: p.detach() for k, p in train.items()},
            self._audit_layout, grad_norm=pre, clipped_norm=post)
        w = self._audit_window
        if w.maxlen is not None and len(w) == w.maxlen:
            stat_add("hapi/audit_window_dropped")
        w.append((self._step_counter, vec, self._audit_layout))

    def _counted_flops(self, inputs):
        """The counted FLOPs of one train step of a GPT network on
        ``inputs[0]`` ``[batch, seq]`` (``program_registry.
        gpt_step_cost``: causal attention over each row's own prefix, the
        tied head over every row); None for another network — never a
        made-up number."""
        if not inputs or getattr(inputs[0], "dim", lambda: 0)() != 2:
            return None
        key = tuple(inputs[0].shape)
        if key not in self._step_flops:
            gpt = getattr(self.network, "gpt", self.network)
            cfg = getattr(gpt, "cfg", None)
            flops = None
            if cfg is not None and hasattr(cfg, "num_hidden_layers"):
                B, T = key
                flops = _registry.gpt_step_cost(
                    cfg, B * T, B * T * (T + 1) // 2, B * T,
                    train=True)["flops"]
            self._step_flops[key] = flops
        return self._step_flops[key]

    def _observe_compute(self):
        """Achieved FLOP/s (and MFU against the card's peak) over the
        steps since the last window: ``hapi/flops_per_sec`` when the
        steps' FLOPs are counted, ``hapi/mfu`` (and an ``mfu`` log) only
        with a known peak (``program_registry.peak_flops``, overridable
        with ``PADDLE_TPU_PEAK_FLOPS``; the CPU has none)."""
        now = time.perf_counter()
        flops, self._flush_flops = self._flush_flops, 0.0
        steps, self._flush_steps = self._flush_steps, 0
        # re-armed by the next step, not at `now`: time between an
        # epoch's last window and the next step must not dilute it
        t0, self._flush_t0 = self._flush_t0, None
        out = {}
        if not flops or not steps or t0 is None or now <= t0:
            return out
        achieved = flops / (now - t0)
        stat_observe("hapi/flops_per_sec", achieved)
        peak = _registry.peak_flops()
        if peak:
            out["mfu"] = achieved / peak
            stat_observe("hapi/mfu", out["mfu"])
        return out

    def _update_memory_ledger(self):
        """Register the train state's bytes in the memory ledger
        (profiler/memory.py): the parameters, the optimizer's slots (the
        f32 masters included) and the buffers. Host arithmetic over shapes
        only. A weakref finalizer drops the keys with the Model."""
        if self._ledger_base is None:
            self._ledger_base = self._site.replace(
                "hapi/train_step", "hapi/state", 1)
            weakref.finalize(self, _drop_ledger_keys, [
                f"{self._ledger_base}/{k}"
                for k in ("params", "opt_state", "buffers")])
        base = self._ledger_base
        _memory.ledger_set(f"{base}/params",
                           _nbytes(self.network.parameters()))
        slots = getattr(self._optimizer, "_slots", {}) or {}
        _memory.ledger_set(f"{base}/opt_state", _nbytes(
            t for d in slots.values() for t in d.values()
            if torch.is_tensor(t)))
        _memory.ledger_set(f"{base}/buffers",
                           _nbytes(self.network.buffers()))

    def _flush(self, loss, metrics):
        """A log window: ONE device-to-host copy of the last loss and the
        window's audit vectors, then the logs, the window's FLOP/s, a
        memory sample and the numerics policy (``halt`` raises here)."""
        entries = list(self._audit_window)
        self._audit_window.clear()
        with _prof.record("hapi/host_sync", "hapi",
                          args={"audits": len(entries)}):
            if entries:
                host = torch.cat([loss.detach().float().reshape(1)]
                                 + [v for _, v, _ in entries]).cpu().numpy()
                loss, at = float(host[0]), 1
                fetched = []
                for step, v, layout in entries:
                    fetched.append((step, host[at:at + v.numel()], layout))
                    at += v.numel()
            logs = self._pack_logs(loss, metrics)
        logs.update(self._observe_compute())
        _memory.sample("hapi/flush", steps=self._step_counter)
        self._update_memory_ledger()
        if entries:
            logs.update(self._flush_numerics(fetched))
        return logs

    def _flush_numerics(self, entries):
        """The window's fetched audits into the numerics recorder, grouped
        by the layout each was made under. Raises only ``NumericsError``
        (halt mode)."""
        rec = self._numerics_recorder
        if rec is None:
            return {}
        retrace_now = stat_get("dispatch/retrace_cause")
        delta, self._retrace_mark = retrace_now - self._retrace_mark, \
            retrace_now
        scaler = amp.active_scaler()
        kwargs = dict(
            mode=self._numerics_mode,
            lr=float(self._optimizer.get_lr()),
            scaler=scaler.state() if scaler is not None else None,
            retrace_delta=int(delta), ledger_bytes=_memory.ledger_total(),
            context={"site": self._site})
        logs = {}
        i, n = 0, len(entries)
        while i < n:
            layout = entries[i][2]
            j = i
            while j < n and entries[j][2] is layout:
                j += 1
            logs = rec.record_window(
                [(step, v) for step, v, _ in entries[i:j]], layout,
                **kwargs)
            i = j
        return logs

    def dump_numerics(self, path=None):
        """On-demand snapshot of the training numerics flight recorder
        (ring tail, anomalies, scaler state, monitor snapshot, memory
        postmortem path) as JSON; the file path, or ``None`` when
        numerics was never armed on this Model."""
        rec = self._numerics_recorder
        if rec is None:
            return None
        return rec.postmortem(None, path=path, context={"site": self._site})

    def _update_metrics(self, outs, labels):
        results = []
        for m in self._metrics:
            correct = m.compute(*outs, *labels)
            results.append(m.update(*(correct if isinstance(correct, tuple)
                                      else (correct,))))
        return results

    def _pack_logs(self, loss, metrics):
        logs = {"loss": float(loss)}   # the window's one host sync
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
        the metrics' results beside it when there are metrics. With
        ``update=False`` the batch's gradients are added to ``.grad`` and
        nothing steps (gradient accumulation); the next ``update=True``
        call steps on the summed gradients and clears them. Static mode
        takes only ``update=True`` (ROADMAP Queue 1 item 5)."""
        self.network.train()
        labels = self._to_device(_to_list(labels))
        loss, outs = self._train_step(self._to_device(_to_list(inputs)),
                                      labels, update)
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
            with torch.no_grad(), _prof.record("hapi/eval_batch", "hapi"):
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
    def _maybe_prefetch(self, loader, prefetch, buffer_size=2):
        """``loader`` through ``io.device_prefetch`` onto the Model's device
        unless ``prefetch`` is off (``None`` defers to
        ``FLAGS_hapi_prefetch``) or static mode is on."""
        if loader is None or self._static() is not None:
            return loader
        if prefetch is None:
            prefetch = bool(flag_value("FLAGS_hapi_prefetch"))
        if not prefetch:
            return loader
        return device_prefetch(loader, buffer_size=buffer_size,
                               device=self.device)

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
        ``save_freq`` epochs and at the end. Batches reach the device
        through ``io.device_prefetch``, ``prefetch_buffer_size`` ahead,
        unless ``prefetch`` is off (``None``: ``FLAGS_hapi_prefetch``)."""
        for opt, value, item in (("analyze", analyze, 5),
                                 ("zero", zero, 4),
                                 ("grad_comm", grad_comm, 4)):
            if value not in (None, False, 0, "off", "fp32"):
                raise _not_ported(f"fit({opt}=...)", item)
        if numerics is None:
            numerics = _numerics.flag_mode()
        elif numerics not in _numerics.MODES:
            raise ValueError(f"numerics must be one of {_numerics.MODES}, "
                             f"got {numerics!r}")
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
        self._numerics_mode = numerics
        self._audit_window.clear()
        if numerics != "off":
            if self._numerics_recorder is None:
                self._numerics_recorder = _numerics.NumericsRecorder()
            # the ring persists across fits; the loss-spike baseline not
            self._numerics_recorder.new_run()
            self._audit_layout = _numerics.AuditLayout.build(
                list(self._audit_params()))
            self._audit_collect = True
            self._retrace_mark = stat_get("dispatch/retrace_cause")
        if self._optimizer is not None:
            self._optimizer._audit_clip = numerics != "off"
        self._flush_flops, self._flush_steps, self._flush_t0 = 0.0, 0, None
        self._update_memory_ledger()
        cbks.on_train_begin()
        try:
            for epoch in range(epochs):
                if self.stop_training:
                    break
                cbks.on_epoch_begin(epoch)
                for m in self._metrics:
                    m.reset()
                logs, last, metrics = {}, None, []
                with _closing(self._maybe_prefetch(
                        loader, prefetch, prefetch_buffer_size),
                        loader) as data_iter:
                    for step, batch in enumerate(data_iter):
                        cbks.on_train_batch_begin(step)
                        inputs, labels = (self._to_device(t) for t in
                                          self._split_batch(batch))
                        last, outs = self._train_step(inputs, labels)
                        if self._metrics:
                            metrics = self._update_metrics(outs, labels)
                        if log_freq > 0 and step % log_freq == 0:
                            logs = self._flush(last, metrics)
                        cbks.on_train_batch_end(step, logs)
                if last is not None:
                    logs = self._flush(last, metrics)
                cbks.on_epoch_end(epoch, logs)
                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    self.evaluate(eval_loader, batch_size=batch_size,
                                  verbose=verbose, callbacks=cbks,
                                  prefetch=prefetch, _inside_fit=True)
            cbks.on_train_end()
        except BaseException as e:
            # an out-of-memory death leaves the memory picture behind
            # (the timeline, the ledger, the largest live tensors) as
            # JSON; best effort, it never masks the original error
            if _memory.is_resource_exhausted(e):
                _memory.oom_postmortem(e, extra={"phase": "Model.fit"})
            cbks.on_train_abort()
            raise
        finally:
            self._audit_collect = False
            if self._optimizer is not None:
                self._optimizer._audit_clip = False

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, prefetch=None,
                 _inside_fit=False):
        """The mean of the batches' losses (``"loss"``, 0.0 for batches
        without labels) and each metric's accumulated value over
        ``eval_data``, its batches prefetched as ``fit``'s are."""
        loader = self._as_loader(eval_data, batch_size, False, num_workers,
                                 False)
        for m in self._metrics:
            m.reset()
        cbks = callbacks if _inside_fit else config_callbacks(
            callbacks, model=self, verbose=verbose,
            metrics=self._metric_names())
        cbks.on_eval_begin()
        total_loss, n = 0.0, 0
        with _closing(self._maybe_prefetch(loader, prefetch),
                      loader) as data_iter:
            for step, batch in enumerate(data_iter):
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
        optimizer, ``path.pdopt`` (its ``state_dict``). With
        ``training=False`` the inference export instead:
        ``jit.save(network, path, input_spec=inputs)`` (``path.pdmodel``,
        ``.pdiparams``, ``.meta.json``), traced under ``prepare``'s AMP
        policy, so that the artifact computes what ``predict`` does."""
        if not training:
            from .. import jit
            with self._maybe_amp():
                jit.save(self.network, path, input_spec=self._inputs or None)
            return
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
        """The network's parameter counts, ``{"total_params",
        "trainable_params"}``. With ``input_size`` the table of
        ``hapi.summary`` (each leaf layer's output shape and parameters,
        from one forward on zeros or uniform draws of that size, in
        ``dtype``); without, as in the JAX package, the network's repr
        and its total."""
        from .model_summary import summary
        if input_size is not None:
            return summary(self.network, input_size, dtypes=dtype)
        total = sum(p.numel() for p in self.network.parameters())
        trainable = sum(p.numel() for p in self.network.parameters()
                        if p.requires_grad)
        print(f"{self.network!r}\nTotal params: {total:,}")
        return {"total_params": total, "trainable_params": trainable}
