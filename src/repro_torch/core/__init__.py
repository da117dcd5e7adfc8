"""Conv geometry, the planner, the executor registry and the graph layer."""
