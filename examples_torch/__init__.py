"""Example scripts of the PyTorch port (``ku_torch``), beside ``examples/``."""
