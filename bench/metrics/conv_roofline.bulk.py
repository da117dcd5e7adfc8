"""conv_roofline.bulk: see ``bench/readers.py``."""
from bench.readers import conv_roofline as read  # noqa: F401
