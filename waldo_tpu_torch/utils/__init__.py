from .device import resolve_device
from .shapes import gather_time
