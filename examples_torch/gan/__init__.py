"""The vanilla GAN example of the PyTorch port."""
