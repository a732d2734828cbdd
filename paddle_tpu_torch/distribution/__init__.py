"""``distribution`` (counterpart of ``paddle_tpu/distribution/
__init__.py``): Normal, Uniform, Categorical, Beta, Dirichlet,
Independent, Multinomial, TransformedDistribution, the transforms and
the KL registry, over float32 torch tensors.

``log_prob``, ``entropy`` and ``kl_divergence`` are the JAX package's
closed forms. Sampling: ``seed=0`` (the default) draws from the port's
stream on the parameters' device (``framework.random``, which
``paddle_tpu_torch.seed`` reseeds); a nonzero seed draws from a
dedicated ``torch.Generator`` seeded with it, so that the draw is
reproducible. The draws are the same distributions as the JAX
package's, not the same numbers. Beta and Dirichlet draw through
``torch._standard_gamma``; Categorical and Multinomial by Gumbel-max, as
``jax.random.categorical`` does. A parameter given as a tensor keeps its
autograd graph, so ``rsample`` is differentiable in it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple, Type

import torch
import torch.nn.functional as TF

from ..framework import random as _random
from ..framework.place import to_torch_device

__all__ = ["Distribution", "Normal", "Uniform", "Categorical", "Beta",
           "Dirichlet", "kl_divergence", "register_kl",
           "ExponentialFamily", "Independent", "Multinomial",
           "TransformedDistribution"]


def _arr(x, device=None):
    if isinstance(x, torch.Tensor):
        return x.float() if device is None else x.float().to(device)
    return torch.as_tensor(x, dtype=torch.float32,
                           device=device if device is not None
                           else to_torch_device(None))


def _params(*xs):
    """The parameters as float32 tensors on one device: the first
    tensor's, else the current place."""
    device = next((x.device for x in xs if isinstance(x, torch.Tensor)),
                  None)
    if device is None:
        device = to_torch_device(None)
    return [_arr(x, device) for x in xs]


def _generator(seed, device):
    """``seed`` 0 draws from the port's stream on ``device``; a nonzero
    seed from a generator of its own."""
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return _random.get_generator(device)


def _gumbel_argmax(logits, shape, gen):
    """Draws of shape ``shape`` (which ends in the batch shape) from the
    categorical over ``logits``' last axis."""
    u = torch.rand(tuple(shape) + (logits.shape[-1],), generator=gen,
                   device=logits.device)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + g, dim=-1)


class Distribution:
    """The base: ``batch_shape``, ``event_shape`` and the interface."""

    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)

    @property
    def batch_shape(self):
        return self._batch_shape

    @property
    def event_shape(self):
        return self._event_shape

    def sample(self, shape=()):
        raise NotImplementedError

    def rsample(self, shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return torch.exp(self.log_prob(value))

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        return kl_divergence(self, other)


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _params(loc, scale)
        super().__init__(batch_shape=torch.broadcast_shapes(
            self.loc.shape, self.scale.shape))

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return self.scale ** 2

    def _eps(self, shape, seed):
        gen = _generator(seed, self.loc.device)
        return torch.randn(tuple(shape) + self.batch_shape, generator=gen,
                           device=self.loc.device)

    def sample(self, shape=(), seed=0):
        with torch.no_grad():
            return self.loc + self.scale * self._eps(shape, seed)

    def rsample(self, shape=(), seed=0):
        """A reparameterised draw ``loc + scale * eps``, differentiable in
        tensor ``loc``/``scale``."""
        return self.loc + self.scale * self._eps(shape, seed)

    def log_prob(self, value):
        v = _arr(value, self.loc.device)
        var = self.scale ** 2
        return (-((v - self.loc) ** 2) / (2 * var) - torch.log(self.scale)
                - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        ent = 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale)
        return torch.broadcast_to(ent, self.batch_shape)

    def probs(self, value):
        return self.prob(value)


class Uniform(Distribution):
    """``U[low, high)``."""

    def __init__(self, low, high, name=None):
        self.low, self.high = _params(low, high)
        super().__init__(batch_shape=torch.broadcast_shapes(
            self.low.shape, self.high.shape))

    def _u(self, shape, seed):
        gen = _generator(seed, self.low.device)
        return torch.rand(tuple(shape) + self.batch_shape, generator=gen,
                          device=self.low.device)

    def sample(self, shape=(), seed=0):
        with torch.no_grad():
            return self.low + self._u(shape, seed) * (self.high - self.low)

    def rsample(self, shape=(), seed=0):
        return self.low + self._u(shape, seed) * (self.high - self.low)

    def log_prob(self, value):
        v = _arr(value, self.low.device)
        inside = (v >= self.low) & (v < self.high)
        lp = -torch.log(self.high - self.low)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def entropy(self):
        return torch.log(self.high - self.low)


class Categorical(Distribution):
    """Over the last axis of ``logits``."""

    def __init__(self, logits, name=None):
        (self.logits,) = _params(logits)
        self._log_p = torch.log_softmax(self.logits, dim=-1)
        super().__init__(batch_shape=self.logits.shape[:-1])

    @property
    def probs_tensor(self):
        return torch.exp(self._log_p)

    def sample(self, shape=(), seed=0):
        gen = _generator(seed, self.logits.device)
        with torch.no_grad():
            return _gumbel_argmax(self.logits, tuple(shape)
                                  + self.batch_shape, gen)

    def log_prob(self, value):
        v = torch.as_tensor(value, device=self.logits.device).long()
        k = self._log_p.shape[-1]
        lead = torch.broadcast_shapes(v.shape, self._log_p.shape[:-1])
        lp = self._log_p.expand(*lead, k)
        return torch.gather(lp, -1, v.expand(lead)[..., None])[..., 0]

    def probs(self, value):
        return self.prob(value)

    def entropy(self):
        p = torch.exp(self._log_p)
        return -(p * self._log_p).sum(-1)


class ExponentialFamily(Distribution):
    """The exponential-family base, ``p(x) = h(x) exp(<eta, T(x)> -
    A(eta))``: the gradient of ``_log_normalizer`` in the natural
    parameters is the expected sufficient statistic, so the generic
    entropy and KL need no per-family algebra."""

    @property
    def _natural_parameters(self) -> tuple:
        raise NotImplementedError

    def _log_normalizer(self, *natural_params):
        raise NotImplementedError

    @property
    def _mean_carrier_measure(self):
        return 0.0

    def _grads(self, nparams):
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in nparams]
            total = self._log_normalizer(*leaves).sum()
            return torch.autograd.grad(total, leaves)

    def entropy(self):
        """``A(eta) - <eta, grad A(eta)> + E[-log h]`` (the Bregman
        form)."""
        nparams = tuple(self._natural_parameters)
        lognorm = self._log_normalizer(*nparams)
        ent = lognorm + self._mean_carrier_measure
        for np_, g in zip(nparams, self._grads(nparams)):
            if np_.dim() > lognorm.dim():
                ent = ent - (np_ * g).reshape(
                    *np_.shape[:lognorm.dim()], -1).sum(-1)
            else:
                ent = ent - np_ * g
        return ent


def _lbeta(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


class Beta(ExponentialFamily):
    def __init__(self, alpha, beta):
        self.alpha, self.beta = _params(alpha, beta)
        super().__init__(batch_shape=torch.broadcast_shapes(
            self.alpha.shape, self.beta.shape))

    @property
    def mean(self):
        return self.alpha / (self.alpha + self.beta)

    @property
    def _natural_parameters(self):
        return (self.alpha, self.beta)

    def _log_normalizer(self, a, b):
        return _lbeta(a, b)

    def sample(self, shape=(), seed=0):
        gen = _generator(seed, self.alpha.device)
        full = tuple(shape) + self.batch_shape
        with torch.no_grad():
            x = torch._standard_gamma(self.alpha.expand(full).contiguous(),
                                      generator=gen)
            y = torch._standard_gamma(self.beta.expand(full).contiguous(),
                                      generator=gen)
            return x / (x + y)

    def log_prob(self, value):
        v = _arr(value, self.alpha.device)
        return ((self.alpha - 1) * torch.log(v)
                + (self.beta - 1) * torch.log1p(-v)
                - _lbeta(self.alpha, self.beta))

    def entropy(self):
        a, b = self.alpha, self.beta
        return (_lbeta(a, b) - (a - 1) * torch.digamma(a)
                - (b - 1) * torch.digamma(b)
                + (a + b - 2) * torch.digamma(a + b))


class Dirichlet(ExponentialFamily):
    def __init__(self, concentration):
        (self.concentration,) = _params(concentration)
        super().__init__(batch_shape=self.concentration.shape[:-1],
                         event_shape=self.concentration.shape[-1:])

    @property
    def _natural_parameters(self):
        return (self.concentration,)

    def _log_normalizer(self, a):
        return torch.lgamma(a).sum(-1) - torch.lgamma(a.sum(-1))

    def sample(self, shape=(), seed=0):
        gen = _generator(seed, self.concentration.device)
        full = tuple(shape) + self.batch_shape + self.event_shape
        with torch.no_grad():
            g = torch._standard_gamma(
                self.concentration.expand(full).contiguous(), generator=gen)
            return g / g.sum(-1, keepdim=True)

    def log_prob(self, value):
        v = _arr(value, self.concentration.device)
        a = self.concentration
        norm = torch.lgamma(a.sum(-1)) - torch.lgamma(a).sum(-1)
        return ((a - 1) * torch.log(v)).sum(-1) + norm

    def entropy(self):
        a = self.concentration
        a0 = a.sum(-1)
        k = a.shape[-1]
        lnB = torch.lgamma(a).sum(-1) - torch.lgamma(a0)
        return (lnB + (a0 - k) * torch.digamma(a0)
                - ((a - 1) * torch.digamma(a)).sum(-1))


def _sum_rightmost(value, n):
    return value.sum(tuple(range(-n, 0))) if n > 0 else value


class Independent(Distribution):
    """``base`` with its rightmost ``reinterpreted_batch_rank`` batch
    dimensions taken as event dimensions."""

    def __init__(self, base: Distribution, reinterpreted_batch_rank: int):
        if not (0 < reinterpreted_batch_rank <= len(base.batch_shape)):
            raise ValueError(
                f"reinterpreted_batch_rank must be in (0, "
                f"{len(base.batch_shape)}], got {reinterpreted_batch_rank}")
        self._base = base
        self._reinterpreted_batch_rank = int(reinterpreted_batch_rank)
        shape = base.batch_shape + base.event_shape
        split = len(base.batch_shape) - reinterpreted_batch_rank
        super().__init__(batch_shape=shape[:split],
                         event_shape=shape[split:])

    @property
    def mean(self):
        return self._base.mean

    @property
    def variance(self):
        return self._base.variance

    def sample(self, shape=(), seed=0):
        return self._base.sample(shape, seed=seed)

    def rsample(self, shape=(), seed=0):
        return self._base.rsample(shape, seed=seed)

    def _sum_rightmost(self, value, n):
        return _sum_rightmost(value, n)

    def log_prob(self, value):
        return _sum_rightmost(self._base.log_prob(value),
                              self._reinterpreted_batch_rank)

    def entropy(self):
        return _sum_rightmost(self._base.entropy(),
                              self._reinterpreted_batch_rank)


class Multinomial(Distribution):
    """Counts over k categories from ``total_count`` independent
    draws."""

    def __init__(self, total_count, probs):
        if not isinstance(total_count, int) or total_count < 1:
            raise ValueError("total_count must be an int >= 1")
        (p,) = _params(probs)
        if p.dim() < 1:
            raise ValueError("probs must have at least one dimension")
        self.probs = p / p.sum(-1, keepdim=True)
        self.total_count = total_count
        self._categorical = Categorical(torch.log(self.probs))
        super().__init__(batch_shape=p.shape[:-1],
                         event_shape=p.shape[-1:])

    @property
    def mean(self):
        return self.probs * self.total_count

    @property
    def variance(self):
        return self.total_count * self.probs * (1 - self.probs)

    def log_prob(self, value):
        v = _arr(value, self.probs.device)
        logits = torch.log(self.probs)
        # 0 * log(0) := 0 for the impossible categories not drawn
        logits = torch.where((v == 0) & torch.isneginf(logits),
                             torch.zeros_like(logits), logits)
        return (torch.lgamma(v.sum(-1) + 1) - torch.lgamma(v + 1).sum(-1)
                + (v * logits).sum(-1))

    def sample(self, shape=(), seed=0):
        gen = _generator(seed, self.probs.device)
        with torch.no_grad():
            draws = _gumbel_argmax(
                torch.log(self.probs),
                (self.total_count,) + tuple(shape) + self.batch_shape, gen)
            onehot = TF.one_hot(draws, self.probs.shape[-1]).to(
                self.probs.dtype)
            return onehot.sum(0)

    def entropy(self):
        n = float(self.total_count)
        # H = n H(cat) - lgamma(n + 1) + sum_i E[lgamma(X_i + 1)], X_i ~
        # Binomial(n, p_i)
        support = torch.arange(1.0, n + 1, device=self.probs.device)
        support = support.reshape((-1,) + (1,) * self.probs.dim())
        logits = torch.log(self.probs) - torch.log1p(-self.probs)
        lg_n1 = math.lgamma(n + 1)
        norm = (n * torch.clamp_min(logits, 0)
                + n * torch.log1p(torch.exp(-torch.abs(logits))) - lg_n1)
        binom_lp = (support * logits - torch.lgamma(support + 1)
                    - torch.lgamma(n - support + 1) - norm)
        e_lgamma = (torch.exp(binom_lp)
                    * torch.lgamma(support + 1)).sum(0).sum(-1)
        return n * self._categorical.entropy() - lg_n1 + e_lgamma


class TransformedDistribution(Distribution):
    """``base`` pushed through a chain of transforms."""

    def __init__(self, base: Distribution, transforms):
        from .transform import ChainTransform, Transform
        if isinstance(transforms, Transform):
            transforms = [transforms]
        for t in transforms:
            if not isinstance(t, Transform):
                raise TypeError(f"not a Transform: {t!r}")
        self._base = base
        self.transforms = list(transforms)
        chain = ChainTransform(self.transforms)
        base_shape = base.batch_shape + base.event_shape
        out_shape = chain.forward_shape(base_shape)
        event_rank = max(chain._codomain_event_rank,
                         len(base.event_shape))
        split = len(out_shape) - event_rank
        super().__init__(batch_shape=tuple(out_shape[:split]),
                         event_shape=tuple(out_shape[split:]))

    def sample(self, shape=(), seed=0):
        x = self._base.sample(shape, seed=seed)
        for t in self.transforms:
            x = t.forward(x)
        return x

    def rsample(self, shape=(), seed=0):
        x = self._base.rsample(shape, seed=seed)
        for t in self.transforms:
            x = t.forward(x)
        return x

    def log_prob(self, value):
        y = _arr(value)
        event_rank = len(self.event_shape)
        lp = 0.0
        for t in reversed(self.transforms):
            if not t._is_injective():
                raise NotImplementedError(
                    f"log_prob through non-injective "
                    f"{type(t).__name__} is undefined")
            x = t._inverse(y)
            ldj = t.forward_log_det_jacobian(x)
            lp = lp - _sum_rightmost(
                ldj, event_rank - t._codomain_event_rank)
            event_rank += t._domain_event_rank - t._codomain_event_rank
            y = x
        base_lp = self._base.log_prob(y)
        return lp + _sum_rightmost(
            base_lp, event_rank - len(self._base.event_shape))


from .transform import (  # noqa: E402,F401
    AbsTransform, AffineTransform, ChainTransform, ExpTransform,
    IndependentTransform, PowerTransform, ReshapeTransform,
    SigmoidTransform, SoftmaxTransform, StackTransform,
    StickBreakingTransform, TanhTransform, Transform)

__all__ += [
    "Transform", "AbsTransform", "AffineTransform", "ChainTransform",
    "ExpTransform", "IndependentTransform", "PowerTransform",
    "ReshapeTransform", "SigmoidTransform", "SoftmaxTransform",
    "StackTransform", "StickBreakingTransform", "TanhTransform"]


# ---------------------------------------------------------------------------
# the KL registry
# ---------------------------------------------------------------------------

_KL_REGISTRY: Dict[Tuple[Type, Type], Callable] = {}


def register_kl(p_cls, q_cls):
    def deco(fn):
        _KL_REGISTRY[(p_cls, q_cls)] = fn
        return fn
    return deco


def kl_divergence(p: Distribution, q: Distribution):
    for (pc, qc), fn in _KL_REGISTRY.items():
        if isinstance(p, pc) and isinstance(q, qc):
            return fn(p, q)
    raise NotImplementedError(
        f"no KL rule for ({type(p).__name__}, {type(q).__name__})")


@register_kl(Normal, Normal)
def _kl_normal_normal(p, q):
    var_ratio = (p.scale / q.scale) ** 2
    t1 = ((p.loc - q.loc) / q.scale) ** 2
    return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))


@register_kl(Uniform, Uniform)
def _kl_uniform_uniform(p, q):
    r = torch.log((q.high - q.low) / (p.high - p.low))
    outside = (p.low < q.low) | (p.high > q.high)
    return torch.where(outside, torch.full_like(r, math.inf), r)


@register_kl(Categorical, Categorical)
def _kl_categorical_categorical(p, q):
    pp = torch.exp(p._log_p)
    return (pp * (p._log_p - q._log_p)).sum(-1)


@register_kl(Beta, Beta)
def _kl_beta_beta(p, q):
    a1, b1, a2, b2 = p.alpha, p.beta, q.alpha, q.beta
    return (_lbeta(a2, b2) - _lbeta(a1, b1)
            + (a1 - a2) * torch.digamma(a1)
            + (b1 - b2) * torch.digamma(b1)
            + (a2 - a1 + b2 - b1) * torch.digamma(a1 + b1))


@register_kl(Dirichlet, Dirichlet)
def _kl_dirichlet_dirichlet(p, q):
    a, b = p.concentration, q.concentration
    a0 = a.sum(-1)
    lnB_a = torch.lgamma(a).sum(-1) - torch.lgamma(a0)
    lnB_b = torch.lgamma(b).sum(-1) - torch.lgamma(b.sum(-1))
    return (lnB_b - lnB_a
            + ((a - b) * (torch.digamma(a)
                          - torch.digamma(a0)[..., None])).sum(-1))


@register_kl(Independent, Independent)
def _kl_independent_independent(p, q):
    if p._reinterpreted_batch_rank != q._reinterpreted_batch_rank:
        raise NotImplementedError(
            "KL between Independents of different reinterpreted ranks")
    return _sum_rightmost(kl_divergence(p._base, q._base),
                          p._reinterpreted_batch_rank)


@register_kl(ExponentialFamily, ExponentialFamily)
def _kl_expfamily_expfamily(p, q):
    """The same family's KL as the Bregman divergence of the
    log-normalizer: ``A(eta_q) - A(eta_p) - <eta_q - eta_p, grad
    A(eta_p)>``."""
    if type(p) is not type(q):
        raise NotImplementedError(
            f"KL between different families {type(p).__name__} and "
            f"{type(q).__name__}")
    p_np = tuple(p._natural_parameters)
    q_np = tuple(q._natural_parameters)
    kl = q._log_normalizer(*q_np) - p._log_normalizer(*p_np)
    for pn, qn, g in zip(p_np, q_np, p._grads(p_np)):
        term = (pn - qn) * g
        extra = term.dim() - kl.dim()
        if extra > 0:
            term = term.sum(tuple(range(-extra, 0)))
        kl = kl + term
    return kl
