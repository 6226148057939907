"""Resource handle, errors and the chunked corpus reader."""

from . import chunked
from .errors import RaftError, expects, fail
from .resources import Resources, default_resources, set_default_resources

__all__ = ["chunked", "RaftError", "expects", "fail", "Resources", "default_resources",
           "set_default_resources"]
