"""The NobodyConvNet2D MNIST example of the PyTorch port."""
