"""Synthetic, shard-deterministic training data (the reference's
``repro/data``)."""
