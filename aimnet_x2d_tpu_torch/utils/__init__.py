from .activation import get_activation_function
from .device import resolve_device

__all__ = ["get_activation_function", "resolve_device"]
