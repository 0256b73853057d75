"""The transformer examples of the PyTorch port."""
