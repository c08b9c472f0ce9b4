"""Training: state and Keras-style Adam, train/eval steps, callbacks,
checkpoints and the epoch loop of the PyTorch port."""
