"""PyTorch + CUDA port of ``fetal_mri_segmentation_tpu`` for NVIDIA Hopper.

Covers sliding-window serving of the 3D U-Net: ``config`` (the JAX
package's ``Config``), ``models`` (``UNet3D``), ``ops`` (the hand-written
Hopper kernels ``conv3x3`` and ``dec0`` with their plain PyTorch twins,
patch-grid math), ``data.normalize``, ``inference``
(``SlidingWindowPredictor``, per-case NIfTI serving), ``utils.params`` (weights from the flax tree) and
the ``predict`` entry point. Imports torch, never jax.
"""
