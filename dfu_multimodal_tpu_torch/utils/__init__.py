"""Checkpoints, the flax msgpack reader and run logging."""
