"""Entry points of the port (``explore``)."""
