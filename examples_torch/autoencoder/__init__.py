"""The autoencoder example of the PyTorch port."""
