"""mfu.bulk: see ``bench/readers.py``."""
from bench.readers import mfu as read  # noqa: F401
