"""Adapters from a configuration to the program under test, found by the
configuration's ``system`` key."""
