"""Resource handle, errors, the chunked corpus reader, cooperative
cancellation, the operator vocabulary and the staging buffer."""

from . import chunked, operators
from .errors import RaftError, expects, fail
from .interruptible import InterruptedException, cancel, interruptible, synchronize
from .resources import Resources, default_resources, set_default_resources
from .temporary_buffer import temporary_device_buffer

__all__ = ["chunked", "RaftError", "expects", "fail", "Resources", "default_resources",
           "set_default_resources", "InterruptedException", "interruptible", "synchronize",
           "cancel", "temporary_device_buffer", "operators"]
