"""Share of its byte roofline (HBM bandwidth) that the parity check kernel
reaches in the traced stretch."""
from hrmbench import readers


def read(rec):
    return readers.kernel_roofline(rec, "parity_check",
                                   "parity_check_kernel")
