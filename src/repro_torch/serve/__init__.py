"""Paged KV cache and the serving engine."""
