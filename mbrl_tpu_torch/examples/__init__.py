"""Shipped configurations (``conf/``) of the port: the PETS part of the JAX package's tree."""
