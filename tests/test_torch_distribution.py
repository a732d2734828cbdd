"""``distribution`` of the PyTorch port against the JAX package's, on the
CPU.

``log_prob``, ``entropy``, ``kl_divergence``, ``mean``/``variance`` and
every transform's ``forward``/``inverse``/``forward_log_det_jacobian``
are compared value for value, within 1e-5 of each result's largest
magnitude (float32, the same closed forms). Samples are compared in
distribution only (the two packages' generators differ): the mean and
variance of 20000 draws within 5 standard errors of the distribution's
(the variance's standard error from the fourth moment); ``seed`` 0
draws from the port's stream, which ``paddle_tpu_torch.seed`` resets,
and a nonzero seed from a dedicated generator (equal draws for equal
seeds). ``rsample`` is differentiable in tensor parameters.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import distribution as JD
import paddle_tpu_torch as pt
from paddle_tpu_torch import distribution as TD

TOL = 1e-5
DRAWS, SE = 20000, 5.0


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t._data if hasattr(t, "_data") else t)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite)
    assert np.array_equal(got[~finite], want[~finite])
    if finite.any():
        np.testing.assert_allclose(
            got[finite], want[finite], rtol=0,
            atol=tol * max(np.abs(want[finite]).max(), 1e-30))


_RS = np.random.RandomState(0)
LOC = _RS.randn(6).astype(np.float32)
SCALE = _RS.uniform(0.5, 2, 6).astype(np.float32)
POS = _RS.uniform(0.5, 4, (6, 4)).astype(np.float32)
LOGITS = _RS.randn(6, 5).astype(np.float32)
UNIT = _RS.uniform(0.05, 0.95, 6).astype(np.float32)


def _make(mod, name):
    """(p, q, a value in p's support) in package ``mod``."""
    return {
        "normal": lambda: (mod.Normal(LOC, SCALE), mod.Normal(LOC + 1,
                                                              SCALE * 2),
                           LOC + 0.3),
        "uniform": lambda: (mod.Uniform(LOC - 1, LOC + 2),
                            mod.Uniform(LOC - 2, LOC + 3),
                            np.where(np.arange(6) % 2, LOC, LOC + 5)
                            .astype(np.float32)),
        "categorical": lambda: (mod.Categorical(LOGITS),
                                mod.Categorical(LOGITS * 0.5),
                                np.arange(6) % 5),
        "beta": lambda: (mod.Beta(POS[:, 0], POS[:, 1]),
                         mod.Beta(POS[:, 2], POS[:, 3]), UNIT),
        "dirichlet": lambda: (mod.Dirichlet(POS), mod.Dirichlet(POS + 1),
                              POS / POS.sum(-1, keepdims=True)),
        "independent": lambda: (
            mod.Independent(mod.Normal(LOC.reshape(2, 3),
                                       SCALE.reshape(2, 3)), 1),
            mod.Independent(mod.Normal(LOC.reshape(2, 3) - 1,
                                       SCALE.reshape(2, 3)), 1),
            LOC.reshape(2, 3)),
        "multinomial": lambda: (mod.Multinomial(7, POS), None,
                                np.array([[2, 1, 3, 1]] * 6, np.float32)),
    }[name]()


NAMES = ["normal", "uniform", "categorical", "beta", "dirichlet",
         "independent", "multinomial"]


@pytest.mark.parametrize("name", NAMES)
def test_closed_forms_match_jax(name):
    jp, jq, v = _make(JD, name)
    tp, tq, _ = _make(TD, name)
    assert tuple(tp.batch_shape) == tuple(jp.batch_shape)
    assert tuple(tp.event_shape) == tuple(jp.event_shape)
    _close(tp.log_prob(torch.tensor(v)), jp.log_prob(paddle.to_tensor(v)))
    _close(tp.prob(torch.tensor(v)), jp.prob(paddle.to_tensor(v)))
    _close(tp.entropy(), jp.entropy())
    if jq is not None:
        _close(TD.kl_divergence(tp, tq), JD.kl_divergence(jp, jq))
        _close(tp.kl_divergence(tq), jp.kl_divergence(jq))
    for attr in ("mean", "variance"):
        if hasattr(type(jp), attr):
            _close(getattr(tp, attr), getattr(jp, attr))


def test_the_generic_exponential_family_forms_match_jax():
    """A subclass with only its natural parameters and log-normalizer
    gets entropy and KL from the gradient of the log-normalizer."""
    def family(mod, base):
        class Gammaish(base):
            def __init__(self, a):
                self.a = a
                super().__init__(batch_shape=a.shape)

            @property
            def _natural_parameters(self):
                return (self.a,)

            def _log_normalizer(self, a):
                lg = torch.lgamma if mod is TD else \
                    __import__("jax").scipy.special.gammaln
                return lg(a)
        return Gammaish

    a = POS[:, 0]
    b = POS[:, 1]
    J, T = family(JD, JD.ExponentialFamily), family(TD, TD.ExponentialFamily)
    import jax.numpy as jnp
    jp, jq = J(jnp.asarray(a)), J(jnp.asarray(b))
    tp, tq = T(torch.tensor(a)), T(torch.tensor(b))
    _close(tp.entropy(), jp.entropy())
    _close(TD.kl_divergence(tp, tq), JD.kl_divergence(jp, jq))
    with pytest.raises(NotImplementedError):
        TD.kl_divergence(tp, TD.Beta(1.0, 2.0))


@pytest.mark.parametrize("name", NAMES)
def test_draws_follow_the_distribution(name):
    tp, _, _ = _make(TD, name)
    draws = tp.sample((DRAWS,), seed=3).double()
    assert tuple(draws.shape) == (DRAWS,) + tuple(tp.batch_shape) + tuple(
        tp.event_shape)
    if name == "categorical":
        p = torch.softmax(torch.tensor(LOGITS).double(), -1)
        k = torch.arange(5.)
        mean, var = (p * k).sum(-1), (p * k * k).sum(-1) - (p * k).sum(-1) ** 2
    elif name == "uniform":
        mean = torch.tensor(LOC + 0.5).double()
        var = torch.full((6,), 0.75).double()
    elif name == "beta":
        a = torch.tensor(POS[:, 0]).double()
        b = torch.tensor(POS[:, 1]).double()
        mean, var = a / (a + b), a * b / ((a + b) ** 2 * (a + b + 1))
    elif name == "dirichlet":
        c = torch.tensor(POS).double()
        mean = c / c.sum(-1, keepdim=True)
        var = mean * (1 - mean) / (c.sum(-1, keepdim=True) + 1)
    elif name == "multinomial":
        p = torch.tensor(POS).double()
        p = p / p.sum(-1, keepdim=True)
        mean, var = 7 * p, 7 * p * (1 - p)
    else:
        mean = torch.tensor(_np(tp.mean)).double()
        var = torch.tensor(_np(tp.variance)).double()
    m, v = draws.mean(0), draws.var(0)
    se_m = (v / DRAWS).sqrt()
    se_v = ((((draws - m) ** 4).mean(0) - v ** 2).clamp_min(0) / DRAWS).sqrt()
    assert ((m - mean).abs() <= SE * se_m + 1e-12).all(), (m, mean)
    assert ((v - var).abs() <= SE * se_v + 1e-12).all(), (v, var)


def test_seeds_and_the_global_stream():
    d = TD.Normal(LOC, SCALE)
    assert torch.equal(d.sample((4,), seed=9), d.sample((4,), seed=9))
    assert not torch.equal(d.sample((4,), seed=9), d.sample((4,), seed=10))
    pt.seed(5)
    a = d.sample((4,))
    b = d.sample((4,))
    pt.seed(5)
    assert torch.equal(d.sample((4,)), a) and not torch.equal(a, b)
    loc = torch.tensor(LOC, requires_grad=True)
    TD.Normal(loc, SCALE).rsample((8,), seed=1).sum().backward()
    assert torch.allclose(loc.grad, torch.full((6,), 8.0))
    low = torch.tensor(LOC, requires_grad=True)
    TD.Uniform(low, LOC + 2).rsample((3,), seed=1).sum().backward()
    assert low.grad is not None


def _transforms(mod):
    return [
        ("abs", mod.AbsTransform(), None),
        ("affine", mod.AffineTransform(LOC[:4], SCALE[:4]), None),
        ("exp", mod.ExpTransform(), None),
        ("power", mod.PowerTransform(2.5), "pos"),
        ("sigmoid", mod.SigmoidTransform(), None),
        ("tanh", mod.TanhTransform(), None),
        ("softmax", mod.SoftmaxTransform(), None),
        ("stick", mod.StickBreakingTransform(), None),
        ("reshape", mod.ReshapeTransform((4,), (2, 2)), None),
        ("independent", mod.IndependentTransform(mod.ExpTransform(), 1),
         None),
        ("stack", mod.StackTransform([mod.ExpTransform(),
                                      mod.TanhTransform()], axis=1), "two"),
        ("chain", mod.ChainTransform([mod.AffineTransform(0.5, 2.0),
                                      mod.SigmoidTransform()]), None),
    ]


@pytest.mark.parametrize("i", range(12))
def test_transforms_match_jax(i):
    jname, jt, kind = _transforms(JD)[i]
    _, tt, _ = _transforms(TD)[i]
    rs = np.random.RandomState(i)
    x = rs.randn(3, 4).astype(np.float32) * 0.8
    if kind == "pos":
        x = np.abs(x) + 0.1
    if kind == "two":
        x = x[:, :2]
    jx, tx = paddle.to_tensor(x), torch.tensor(x)
    jy, ty = jt.forward(jx), tt.forward(tx)
    _close(ty, jy)
    _close(tt.forward_shape(x.shape), jt.forward_shape(x.shape))
    if jname in ("softmax", "abs"):
        return                       # no density: forward and inverse only
    _close(tt.inverse(ty), jt.inverse(jy))
    _close(tt.forward_log_det_jacobian(tx), jt.forward_log_det_jacobian(jx))
    _close(tt.inverse_log_det_jacobian(ty), jt.inverse_log_det_jacobian(jy))


def test_transformed_distribution_matches_jax():
    for mod, pkg, conv in ((JD, paddle, paddle.to_tensor),
                           (TD, pt, torch.tensor)):
        base = mod.Normal(np.zeros(4, np.float32), np.ones(4, np.float32))
        d = mod.TransformedDistribution(
            base, [mod.AffineTransform(1.0, 2.0), mod.ExpTransform()])
        dj = mod.TransformedDistribution(
            mod.Dirichlet(POS[0]), [mod.ReshapeTransform((4,), (2, 2))])
        out = (d.log_prob(conv(np.abs(LOC[:4]) + 0.5)),
               dj.log_prob(conv((POS[0] / POS[0].sum()).reshape(2, 2))),
               d.batch_shape, dj.event_shape,
               mod.ExpTransform()(base).log_prob(conv(UNIT[:4])))
        if mod is JD:
            want = out
        else:
            got = out
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert tuple(g) == tuple(w)
        else:
            _close(g, w)
    with pytest.raises(NotImplementedError, match="non-injective"):
        TD.TransformedDistribution(
            TD.Normal(0.0, 1.0), [TD.AbsTransform()]).log_prob(
                torch.tensor(1.0))
