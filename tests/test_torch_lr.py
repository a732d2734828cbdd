"""The port's learning-rate schedulers against the JAX package's, on the
CPU: each of the 15 schedulers stepped 60 times gives the same Python
floats as its JAX twin (exact: both are the same float64 arithmetic on
the host); ``state_dict`` round-trips a scheduler mid-run; and
``ReduceOnPlateau`` follows a fixed metric sequence the same way."""
import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 60

# name -> (args, kwargs); a callable in args is shared by both packages
CASES = {
    "NoamDecay": ((64, 10), {"learning_rate": 2.0}),
    "PiecewiseDecay": (([10, 25, 40], [0.1, 0.05, 0.01, 0.001]), {}),
    "NaturalExpDecay": ((0.5, 0.1), {}),
    "InverseTimeDecay": ((0.5, 0.2), {}),
    "PolynomialDecay": ((0.5, 20), {"end_lr": 0.01, "power": 2.0,
                                    "cycle": True}),
    "LinearWarmup": (("cosine", 10, 0.0, 0.5), {}),
    "ExponentialDecay": ((0.5, 0.95), {}),
    "MultiStepDecay": ((0.5, [10, 30, 45]), {"gamma": 0.5}),
    "StepDecay": ((0.5, 7), {"gamma": 0.7}),
    "LambdaDecay": ((0.5, lambda e: 0.9 ** e), {}),
    "MultiplicativeDecay": ((0.5, lambda e: 0.97), {}),
    "CosineAnnealingDecay": ((0.5, 25), {"eta_min": 0.01}),
    "ReduceOnPlateau": ((0.5,), {"patience": 2, "factor": 0.5,
                                 "cooldown": 1}),
    "OneCycleLR": ((0.5, 50), {"three_phase": False}),
    "CyclicLR": ((0.05, 0.5), {"step_size_up": 8, "step_size_down": 5,
                               "mode": "triangular2"}),
}

# a metric sequence with improvements, plateaus and a relapse
METRICS = [1.0, 0.9, 0.9, 0.91, 0.95, 0.8, 0.8, 0.8, 0.8, 0.79995, 0.7,
           0.7, 0.71, 0.72, 0.73, 0.74, 0.5, 0.5, 0.5, 0.5] * 3


def _make(mod, name):
    args, kwargs = CASES[name]
    if name == "LinearWarmup":
        args = (mod.CosineAnnealingDecay(0.5, T_max=30),) + args[1:]
    return getattr(mod, name)(*args, **kwargs)


def _trace(sched, name, steps=STEPS):
    """The lr before each step, then the step (``ReduceOnPlateau`` steps
    on the metric sequence)."""
    out = []
    for i in range(steps):
        out.append(sched())
        if name == "ReduceOnPlateau":
            sched.step(METRICS[i])
        else:
            sched.step()
    return out


def test_every_scheduler_is_a_case():
    assert sorted(CASES) == sorted(n for n in jlr.__all__
                                   if n != "LRScheduler")
    assert sorted(tlr.__all__) == sorted(jlr.__all__)


@pytest.mark.parametrize("name", sorted(CASES))
def test_scheduler_matches_jax(name):
    want = _trace(_make(jlr, name), name)
    got = _trace(_make(tlr, name), name)
    assert got == want
    assert all(isinstance(x, float) or isinstance(x, int) for x in got)
    assert len(set(got)) > 1, "the case does not move the lr"


@pytest.mark.parametrize("name", sorted(CASES))
def test_state_dict_round_trip_mid_run(name):
    """A scheduler restored from another's ``state_dict`` at step 23 goes
    on exactly as the original and as the JAX one does."""
    a = _make(tlr, name)
    _trace(a, name, 23)
    b = _make(tlr, name)
    b.set_state_dict(a.state_dict())
    assert b.state_dict() == a.state_dict()
    j = _make(jlr, name)
    _trace(j, name, 23)
    assert a.state_dict() == {k: v for k, v in j.state_dict().items()}
    for _ in range(10):
        assert a() == b() == j()
        for s in (a, b, j):
            if name == "ReduceOnPlateau":
                s.step(0.3)
            else:
                s.step()


def test_reduce_on_plateau_follows_the_metrics():
    j = jlr.ReduceOnPlateau(1.0, mode="min", factor=0.5, patience=1,
                            threshold=0.01, threshold_mode="abs",
                            cooldown=2, min_lr=0.1)
    t = tlr.ReduceOnPlateau(1.0, mode="min", factor=0.5, patience=1,
                            threshold=0.01, threshold_mode="abs",
                            cooldown=2, min_lr=0.1)
    seen = []
    for m in METRICS:
        j.step(m)
        t.step(m)
        seen.append(t())
        assert (t(), t.best, t.num_bad_epochs, t.cooldown_counter,
                t.last_epoch) == (j(), j.best, j.num_bad_epochs,
                                  j.cooldown_counter, j.last_epoch)
    assert min(seen) == 0.1 and seen[0] == 1.0
    t.step(None)                               # no metric: no step
    assert t.last_epoch == len(METRICS)
