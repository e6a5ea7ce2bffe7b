"""Actor-critic networks."""
