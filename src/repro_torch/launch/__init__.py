"""Entry points of the port (``explore``, ``serve``, ``serve_online``,
``train``) and the device grid of sharded domains (``mesh``)."""
