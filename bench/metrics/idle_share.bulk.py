"""idle_share.bulk: see ``bench/readers.py``."""
from bench.readers import idle_share as read  # noqa: F401
