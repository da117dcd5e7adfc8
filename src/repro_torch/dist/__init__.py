"""Distributed execution utilities: the serving placements (``sharding``)."""
