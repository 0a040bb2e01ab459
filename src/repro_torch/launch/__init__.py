"""Entry points of the port (``explore``, ``serve``, ``serve_online``,
``train``, ``dryrun``), the device meshes (``mesh``), and the launch
tooling: shape-only ``meta`` stand-ins for every input (``specs``), the
analytic model FLOPs (``modelflops``) and HBM-traffic floor
(``modelbytes``), and the per-device cost of one eager call with its
roofline terms on the card (``step_cost``)."""
