from .shapes import gather_time
