"""Entry points of the port (``explore``, ``serve``, ``serve_online``,
``train``) and the device meshes (``mesh``)."""
