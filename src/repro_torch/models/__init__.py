"""Model layers of the serving slice."""
