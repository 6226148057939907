"""Random number generation.

Counterpart of raft_tpu/random/rng.py (reference: random/rng.cuh,
rng_state.hpp). The JAX state carries a PRNG key and hands out a subkey a
call; here :class:`RngState` carries a seed stream and hands out a fresh
``torch.Generator`` a call, seeded from that stream, on the device of the
draw. Successive calls are independent and a seed replays them.

JAX's threefry and torch's Philox (CUDA) or Mersenne Twister (CPU) never
give the same bits, so the draws match JAX's by distribution, not value.
Where the JAX module spells out a formula it is kept: ``rayleigh`` draws
its uniform from ``[tiny, 1)``, ``scaled_bernoulli`` gives ``±scale``,
``discrete`` samples the categorical over ``log(max(w, 1e-30))``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources

__all__ = [
    "RngState",
    "as_key",
    "uniform",
    "uniform_int",
    "normal",
    "lognormal",
    "gumbel",
    "logistic",
    "exponential",
    "rayleigh",
    "laplace",
    "bernoulli",
    "scaled_bernoulli",
    "discrete",
]

_f32 = torch.float32
_SEED_BOUND = 1 << 62


@dataclasses.dataclass
class RngState:
    """Mutable RNG stream (reference: raft::random::RngState).

    Each distribution call takes one generator from :meth:`next_key`, so
    successive calls draw fresh values, as the reference's state advances.
    """

    seed: int = 0

    def __post_init__(self):
        self._stream = torch.Generator().manual_seed(int(self.seed))

    def _next_seed(self) -> int:
        return int(torch.randint(0, _SEED_BOUND, (), generator=self._stream))

    def next_key(self, device="cpu") -> torch.Generator:
        """A fresh generator on ``device``, seeded from the stream."""
        return torch.Generator(device=device).manual_seed(self._next_seed())

    def advance(self, n: int = 1) -> None:
        """Skip the next ``n`` generators."""
        for _ in range(n):
            self._next_seed()


def as_key(rng, device=None) -> torch.Generator:
    """A generator on ``device`` (default: the default handle's) from an
    :class:`RngState` (its next one), an int seed or a ``torch.Generator``
    (returned as it is; it must live on ``device``)."""
    dev = torch.device(default_resources().device if device is None else device)
    if isinstance(rng, RngState):
        return rng.next_key(dev)
    if isinstance(rng, int):
        return torch.Generator(device=dev).manual_seed(rng)
    expects(isinstance(rng, torch.Generator),
            "rng must be an RngState, an int seed or a torch.Generator, got %s",
            type(rng).__name__)
    expects(rng.device.type == dev.type,
            "the generator lives on %s but the draw runs on %s", rng.device, dev)
    return rng


def _draw(rng, res):
    res = res or default_resources()
    dev = res.torch_device
    return as_key(rng, dev), dev


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _uniform(g, dev, shape, dtype, low=0.0, high=1.0):
    """JAX's uniform on [low, high): ``low + (high - low)·u``, kept below
    ``high`` (torch's float32 draws are multiples of 2^-24, whose top one
    can round up to ``high``)."""
    u = torch.rand(_shape(shape), generator=g, device=dev, dtype=dtype)
    out = torch.clamp_min(u * (high - low) + low, low)
    if high > low:
        top = torch.nextafter(torch.tensor(high, dtype=dtype), torch.tensor(low, dtype=dtype))
        out = torch.clamp_max(out, top.item())
    return out


def uniform(rng, shape, low=0.0, high=1.0, dtype=_f32, res: Resources | None = None):
    """Uniform on ``[low, high)`` (reference: rng.cuh uniform())."""
    g, dev = _draw(rng, res)
    return _uniform(g, dev, shape, dtype, low, high)


def uniform_int(rng, shape, low, high, dtype=torch.int32, res: Resources | None = None):
    """Integers uniform on ``[low, high)``."""
    g, dev = _draw(rng, res)
    return torch.randint(int(low), int(high), _shape(shape), generator=g, device=dev,
                         dtype=dtype)


def normal(rng, shape, mu=0.0, sigma=1.0, dtype=_f32, res: Resources | None = None):
    g, dev = _draw(rng, res)
    return mu + sigma * torch.randn(_shape(shape), generator=g, device=dev, dtype=dtype)


def lognormal(rng, shape, mu=0.0, sigma=1.0, dtype=_f32, res: Resources | None = None):
    return torch.exp(normal(rng, shape, mu, sigma, dtype, res=res))


def _tiny_uniform(rng, shape, dtype, res):
    """JAX's ``uniform(minval=tiny)``: uniform on ``[tiny, 1)``."""
    g, dev = _draw(rng, res)
    return _uniform(g, dev, shape, dtype, torch.finfo(dtype).tiny, 1.0)


def gumbel(rng, shape, mu=0.0, beta=1.0, dtype=_f32, res: Resources | None = None):
    u = _tiny_uniform(rng, shape, dtype, res)
    return mu + beta * -torch.log(-torch.log(u))


def logistic(rng, shape, mu=0.0, scale=1.0, dtype=_f32, res: Resources | None = None):
    u = _tiny_uniform(rng, shape, dtype, res)
    return mu + scale * (torch.log(u) - torch.log1p(-u))


def exponential(rng, shape, lam=1.0, dtype=_f32, res: Resources | None = None):
    g, dev = _draw(rng, res)
    u = _uniform(g, dev, shape, dtype)
    return -torch.log1p(-u) / lam


def rayleigh(rng, shape, sigma=1.0, dtype=_f32, res: Resources | None = None):
    u = _tiny_uniform(rng, shape, dtype, res)
    return sigma * torch.sqrt(-2.0 * torch.log(u))


def laplace(rng, shape, mu=0.0, scale=1.0, dtype=_f32, res: Resources | None = None):
    # JAX: u uniform on [-1 + eps, 1), sign(u) * log1p(-|u|)
    g, dev = _draw(rng, res)
    u = _uniform(g, dev, shape, dtype, -1.0 + torch.finfo(dtype).eps, 1.0)
    return mu + scale * (torch.sign(u) * torch.log1p(-torch.abs(u)))


def bernoulli(rng, shape, prob=0.5, res: Resources | None = None):
    """Booleans, True with probability ``prob``."""
    g, dev = _draw(rng, res)
    return torch.rand(_shape(shape), generator=g, device=dev) < prob


def scaled_bernoulli(rng, shape, prob=0.5, scale=1.0, dtype=_f32,
                     res: Resources | None = None):
    """Reference: rng.cuh scaled_bernoulli — ``scale`` with probability
    ``prob``, else ``-scale``."""
    b = bernoulli(rng, shape, prob, res=res)
    return torch.where(b, scale, -scale).to(dtype)


def discrete(rng, shape, weights, res: Resources | None = None):
    """Indices drawn proportionally to ``weights`` (reference: rng.cuh
    discrete): the categorical over ``log(max(w, 1e-30))``, int32."""
    g, dev = _draw(rng, res)
    w = torch.clamp_min(torch.as_tensor(weights).to(device=dev, dtype=_f32), 1e-30)
    shape = _shape(shape)
    n = 1
    for s in shape:
        n *= s
    out = torch.multinomial(w / w.sum(), n, replacement=True, generator=g)
    return out.to(torch.int32).reshape(shape)
