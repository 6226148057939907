"""Random number generation, distributions, synthetic data, sampling, R-MAT
(counterpart of raft_tpu/random; reference: raft/random). Draws come from
``torch.Generator`` s on the handle's device, so they match the JAX
package's by distribution, not value."""

from .datagen import make_blobs, make_regression, multi_variable_gaussian
from .rmat import rmat, rmat_rectangular_gen
from .rng import (
    RngState,
    as_key,
    bernoulli,
    discrete,
    exponential,
    gumbel,
    laplace,
    logistic,
    lognormal,
    normal,
    rayleigh,
    scaled_bernoulli,
    uniform,
    uniform_int,
)
from .sampling import excess_subsample, permute, sample_without_replacement

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
    "make_blobs",
    "make_regression",
    "multi_variable_gaussian",
    "permute",
    "sample_without_replacement",
    "excess_subsample",
    "rmat",
    "rmat_rectangular_gen",
]
