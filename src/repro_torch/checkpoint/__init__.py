"""Checkpoint store of the port (``store``): atomic, CRC-verified snapshots
that are the train loop's restart point and its Par+R clean copy."""
