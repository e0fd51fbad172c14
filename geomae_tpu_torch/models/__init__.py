"""Model modules of the serving path."""
