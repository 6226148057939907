"""Resource handle and errors."""

from .errors import RaftError, expects, fail
from .resources import Resources, default_resources, set_default_resources

__all__ = ["RaftError", "expects", "fail", "Resources", "default_resources",
           "set_default_resources"]
