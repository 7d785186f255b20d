"""Synthetic token pipeline (the reference's, copied)."""
