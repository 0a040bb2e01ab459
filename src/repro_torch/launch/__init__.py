"""Entry points of the port (``explore``, ``serve``, ``train``)."""
