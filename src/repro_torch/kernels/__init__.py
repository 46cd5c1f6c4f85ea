"""Hand-written GPU kernels of the port and their plain torch versions."""
