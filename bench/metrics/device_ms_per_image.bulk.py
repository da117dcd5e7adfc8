"""device_ms_per_image.bulk: see ``bench/readers.py``."""
from bench.readers import device_ms_per_image as read  # noqa: F401
