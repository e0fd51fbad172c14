"""Box utilities."""
