"""Core data structures of the port: routing and device resolution."""
