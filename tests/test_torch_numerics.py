"""Training numerics health (``paddle_tpu_torch.profiler.numerics`` and
``Model.fit(numerics=...)``) against the JAX package on the CPU.

* two steps of a tiny GPT (2 layers, hidden 64, 4 heads, float32) from
  the same weights and batches through both packages' ``fit(numerics=
  "record")``: the recorded audits give the same finite bits and
  per-group nonfinite counts, exactly, and the loss and the four norms
  (grad, clipped, parameter, update) within a relative 1e-5 in float32 —
  without a clip, with a ``ClipGradByGlobalNorm`` (whose norm the audit
  reuses), with a per-tensor clip, and with an inf injected into the
  second step's loss. The optimizer is SGD with momentum: Adam scales
  each element's step to about ``lr``, so one gradient element of 1e-12
  in one package and 0 in the other moves Adam's update norm by a whole
  ``lr`` (1.3e-5 of it in this model, a difference of the two trainings,
  not of their audits); SGD's update is ``lr`` times the gradient;
* the same sequence of audits gives the same anomalies (loss spikes by
  robust z-score, nonfinite steps) in both ``NumericsRecorder``s;
* ``fit(numerics="halt")`` raises ``NumericsError`` naming the same step
  in both packages, after its postmortem; ``warn`` warns and goes on;
* ``group_params``, ``decode_audit``, ``flag_mode`` and the layout
  constants equal the JAX package's; ``build_audit_flat`` in one process
  equals ``build_audit``.
"""
import json
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.flags import set_flags as jax_set_flags
from paddle_tpu.hapi import Model as JaxModel
from paddle_tpu.io import TensorDataset as JaxTensorDataset
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.nn import ClipGradByGlobalNorm as JaxGlobalClip
from paddle_tpu.nn import ClipGradByNorm as JaxNormClip
from paddle_tpu.nn.layer.layers import get_params_tree
from paddle_tpu.optimizer import Momentum as JaxMomentum
from paddle_tpu.profiler import numerics as jnum
from paddle_tpu_torch.convert import gpt_from_jax_params
from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.models import GPTConfig
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByNorm
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.profiler import numerics as tnum

LR = 0.05
REL = 1e-5
NORMS = ("loss", "grad_norm", "clipped_grad_norm", "param_norm",
         "update_norm")


def _data(seed=11, rows=4, seq=16):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, JaxGPTConfig.tiny().vocab_size,
                      (rows, seq)).astype(np.int64)
    labels = np.concatenate([ids[:, 1:], np.full((rows, 1), -100)], 1)
    return ids, labels


def _models(seed=5):
    paddle.seed(seed)
    jmodel = JaxGPT(JaxGPTConfig.tiny(), lm_loss_chunks=1)
    params = {k: np.asarray(v) for k, v in get_params_tree(jmodel).items()}
    net = gpt_from_jax_params(params, GPTConfig.tiny(), device="cpu",
                              lm_loss_chunks=1)
    return jmodel, net


CLIPS = {"none": (None, None),
         "global": (lambda: JaxGlobalClip(0.5),
                    lambda: ClipGradByGlobalNorm(0.5)),
         "per_tensor": (lambda: JaxNormClip(0.1),
                        lambda: ClipGradByNorm(0.1))}


def _fit_both(clip="none", inject=None, mode="record", steps=2,
              log_freq=1):
    """Both packages' ``fit`` over ``steps`` batches of 2 from the same
    weights; returns (port recorder, JAX recorder) snapshots, or the
    errors they raised."""
    jmodel, net = _models()
    ids, labels = _data(rows=2 * steps)
    jclip, tclip = CLIPS[clip]
    out = []
    for m, opt, ds in (
            (JaxModel(jmodel, inputs=["ids", "labels"]),
             JaxMomentum(LR, momentum=0.9, parameters=jmodel.parameters(),
                         grad_clip=jclip() if jclip else None),
             JaxTensorDataset([ids, labels])),
            (Model(net, inputs=["ids", "labels"], device="cpu"),
             Momentum(LR, momentum=0.9, parameters=net.parameters(),
                      grad_clip=tclip() if tclip else None),
             TensorDataset([ids, labels]))):
        m.prepare(opt, loss=lambda loss, logits: loss)
        m._numerics_inject_inf_at = inject
        err = None
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            try:
                m.fit(ds, batch_size=2, shuffle=False, log_freq=log_freq,
                      verbose=0, numerics=mode)
            except Exception as e:          # noqa: BLE001
                err = e
        out.append((m._numerics_recorder.snapshot(), err))
    return out[1], out[0]


def _close(got, want):
    assert got["finite_bits"] == want["finite_bits"], (got, want)
    assert got["nonfinite_groups"] == want["nonfinite_groups"]
    for k in NORMS:
        g, w = got[k], want[k]
        if np.isfinite(w):
            assert g == pytest.approx(w, rel=REL, abs=1e-12), k
        else:
            assert not np.isfinite(g), k


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_audit_records_match_jax(clip):
    (got, _), (want, _) = _fit_both(clip)
    assert [r["step"] for r in got["records"]] == \
        [r["step"] for r in want["records"]] == [1, 2]
    for g, w in zip(got["records"], want["records"]):
        _close(g, w)
        assert g["finite"] and g["finite_bits"] == tnum.FINITE_ALL
    if clip == "global":
        # the 0.5 clip bites: the clipped norm is the clip norm
        assert got["records"][0]["clipped_grad_norm"] == pytest.approx(0.5)
        assert got["records"][0]["grad_norm"] > 0.5


@pytest.mark.parametrize("clip", ["none", "global"])
def test_injected_inf_gives_the_jax_bits_and_counts(clip):
    (got, _), (want, _) = _fit_both(clip, inject=2)
    g, w = got["records"][1], want["records"][1]
    _close(got["records"][0], want["records"][0])
    assert g["finite_bits"] == w["finite_bits"] == 0
    assert g["nonfinite_groups"] == w["nonfinite_groups"]
    assert sum(g["nonfinite_groups"].values()) > 0
    assert [a["step"] for a in got["anomalies"]] == \
        [a["step"] for a in want["anomalies"]] == [2]
    assert got["anomalies"][0]["blamed_groups"] == \
        want["anomalies"][0]["blamed_groups"]


def test_halt_raises_at_the_same_step_in_both_packages():
    (got, terr), (want, jerr) = _fit_both(inject=2, mode="halt", steps=3)
    assert isinstance(terr, tnum.NumericsError)
    assert isinstance(jerr, jnum.NumericsError)
    assert "at step 2" in str(terr) and "at step 2" in str(jerr)
    path = str(terr).rsplit("anomaly postmortem: ", 1)[1]
    with open(path) as f:
        doc = json.load(f)
    assert doc["anomaly"]["step"] == 2 and doc["memory_postmortem"]
    # the window that held step 2 was the last one recorded
    assert [r["step"] for r in got["records"]] == \
        [r["step"] for r in want["records"]]


def test_warn_dumps_and_goes_on():
    (got, terr), (want, jerr) = _fit_both(inject=2, mode="warn", steps=3,
                                          log_freq=10)
    assert terr is None and jerr is None
    assert [a["step"] for a in got["anomalies"]] == \
        [a["step"] for a in want["anomalies"]]
    assert got["steps_recorded"] == want["steps_recorded"] == 3


def _vec(loss, mod, groups=2, bits=None, counts=None):
    v = np.zeros(mod.N_FIXED + groups, np.float32)
    v[mod.IDX_BITS] = mod.FINITE_ALL if bits is None else bits
    v[mod.IDX_LOSS] = loss
    v[mod.IDX_GRAD_NORM] = 2.0
    v[mod.IDX_CLIPPED_NORM] = 1.0
    v[mod.IDX_PARAM_NORM] = 10.0
    v[mod.IDX_UPDATE_NORM] = 0.01
    if counts:
        v[mod.N_FIXED:] = counts
    return v


def test_the_same_losses_give_the_same_anomalies():
    losses = [3.0, 2.9, 2.95, 2.88, 2.86, 2.9, 2.85, 2.84, 2.83, 9.0,
              2.8, 2.79, float("nan"), 2.78]
    snaps = []
    for mod in (tnum, jnum):
        layout = mod.AuditLayout.build(["a.w", "a.b", "b.w"])
        rec = mod.NumericsRecorder(spike_min_history=8)
        rec.new_run()
        entries = []
        for i, l in enumerate(losses):
            bad = not np.isfinite(l)
            entries.append((i + 1, _vec(l, mod, len(layout.groups),
                                        bits=0 if bad else None,
                                        counts=[3, 0] if bad else None)))
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            logs = rec.record_window(entries[:7], layout, mode="record",
                                     lr=0.1)
            logs2 = rec.record_window(entries[7:], layout, mode="warn",
                                      lr=0.1, scaler={"scale": 4.0})
        snaps.append((rec.anomaly_list(), logs, logs2,
                      [(r["step"], r["finite"], r["update_ratio"],
                        r["clip_ratio"]) for r in rec.snapshot()["records"]]))
    assert snaps[0] == snaps[1]
    kinds = [(a["kind"], a["step"]) for a in snaps[0][0]]
    assert kinds == [("loss_spike", 10), ("nonfinite", 13)]


def test_helpers_equal_the_jax_helpers():
    names = [f"gpt.blocks.{i}.{m}.{p}" for i in range(40)
             for m in ("attn", "mlp") for p in ("weight", "bias")]
    names += ["gpt.wte.weight", "gpt.ln_f.weight"]
    for cap in (4, 32, 100):
        assert tnum.group_params(names, cap) == jnum.group_params(names, cap)
    layout = tnum.AuditLayout.build(names[:7])
    jlayout = jnum.AuditLayout.build(names[:7])
    assert (layout.groups, layout.members, layout.size) == \
        (jlayout.groups, jlayout.members, jlayout.size)
    vec = _vec(2.5, tnum, len(layout.groups), bits=3,
               counts=[1] + [0] * (len(layout.groups) - 1))
    assert tnum.decode_audit(vec, layout) == jnum.decode_audit(vec, layout)
    for k in ("MODES", "N_FIXED", "FINITE_ALL", "IDX_BITS", "IDX_LOSS",
              "IDX_GRAD_NORM", "IDX_CLIPPED_NORM", "IDX_PARAM_NORM",
              "IDX_UPDATE_NORM", "BIT_LOSS", "BIT_GRADS", "BIT_UPDATE"):
        assert getattr(tnum, k) == getattr(jnum, k), k
    for value in ("", "warn", "HALT", "1", "junk"):
        set_flags({"FLAGS_numerics": value})
        jax_set_flags({"FLAGS_numerics": value})
        try:
            assert tnum.flag_mode() == jnum.flag_mode(), value
        finally:
            set_flags({"FLAGS_numerics": ""})
            jax_set_flags({"FLAGS_numerics": ""})


def test_build_audit_flat_in_one_process_equals_build_audit():
    g = torch.Generator().manual_seed(0)
    params = {"a.w": torch.randn(3, 4, generator=g),
              "b.w": torch.randn(5, generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    grads["b.w"][1] = float("nan")
    new = {k: v - 0.1 * grads[k].nan_to_num() for k, v in params.items()}
    layout = tnum.AuditLayout.build(list(params))
    loss = torch.tensor(1.5)
    want = tnum.build_audit(loss, grads, params, new, layout)
    order = [k for gname in layout.groups for k in layout.members[gname]]
    ids = torch.cat([torch.full((params[k].numel(),), i)
                     for i, gname in enumerate(layout.groups)
                     for k in layout.members[gname]])
    flat = lambda d: torch.cat([d[k].reshape(-1) for k in order])  # noqa
    got = tnum.build_audit_flat(loss, flat(grads), flat(params), flat(new),
                                ids, layout)
    assert torch.equal(got[:2], want[:2])
    assert torch.allclose(got, want, equal_nan=True)
    assert tnum.decode_audit(got.numpy(), layout)["nonfinite_groups"] == \
        {"b": 1}


def test_numerics_off_records_nothing_and_a_bad_mode_raises():
    jmodel, net = _models()
    ids, labels = _data()
    m = Model(net, inputs=["ids", "labels"], device="cpu")
    m.prepare(Momentum(LR, parameters=net.parameters()),
              loss=lambda loss, logits: loss)
    m.fit(TensorDataset([ids, labels]), batch_size=2, verbose=0)
    assert m._numerics_recorder is None and m.dump_numerics() is None
    with pytest.raises(ValueError, match="numerics must be one of"):
        m.fit(TensorDataset([ids, labels]), batch_size=2, verbose=0,
              numerics="loud")
    m.fit(TensorDataset([ids, labels]), batch_size=2, verbose=0,
          numerics="record", log_freq=1)
    assert m._numerics_recorder.steps_recorded == 2
    path = m.dump_numerics()
    with open(path) as f:
        assert json.load(f)["reason"] == "requested"
