"""The StyleGAN examples of the PyTorch port."""
