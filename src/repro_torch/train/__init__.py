"""Training: AdamW with the cosine schedule and global-norm clipping, and
the train step and loop."""
