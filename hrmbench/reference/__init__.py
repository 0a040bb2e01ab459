"""The plain reference that decides ``correct``: float32 PyTorch with TF32
off, written from the architecture's equations, importing nothing of the
port. ``model`` is the forward pass (and the fp8 control), ``judge`` the
comparisons, ``campaign`` the Fig. 2 campaign's draws and verdicts."""
