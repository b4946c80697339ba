from .activation import get_activation_function
from .device import resolve_device
from .random import set_seed

__all__ = ["get_activation_function", "resolve_device", "set_seed"]
