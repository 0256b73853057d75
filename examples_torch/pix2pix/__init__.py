"""The pix2pix example of the PyTorch port."""
