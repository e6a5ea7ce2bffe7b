"""Parameter-server update rules."""
