"""Plain float32 references of model families that the JAX package does not
have, written from their published equations in plain PyTorch. They import
nothing of the port (``fetal_mri_segmentation_tpu_torch``), of the JAX
package or of JAX, and run wherever PyTorch runs."""
