"""Replay buffers, device datasets, logging, checkpoints and rollout helpers."""
