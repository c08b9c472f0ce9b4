"""Host data pipeline of the PyTorch port: patch generators, the in-memory
data file and the prefetch thread."""
