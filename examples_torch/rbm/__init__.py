"""The RBM examples of the PyTorch port."""
