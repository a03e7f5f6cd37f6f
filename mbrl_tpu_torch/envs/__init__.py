"""Batched reward/termination functions and PETS env model hooks."""
