"""Optimizer of the port: AdamW (``adamw``) and int8 gradient compression
with error feedback (``compress``)."""
