"""Sharding layer of the port: where each leaf of the parameters, the
optimizer moments, a batch and a decode cache lies on a named mesh
(``rules``), and the thread's ambient mesh with the device-free
``AbstractMesh`` (``mesh``)."""
