"""Synthetic data of the port (``synthetic``)."""
