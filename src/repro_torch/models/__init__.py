"""CNN models planned as one graph program."""
