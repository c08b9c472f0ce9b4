"""PyTorch + CUDA port of ``fetal_mri_segmentation_tpu`` for NVIDIA Hopper.

Covers serving and training of the 3D U-Net on one device: ``config`` (a
copy of the JAX package's ``Config``), ``models`` (``UNet3D``), ``ops``
(the hand-written Hopper kernels ``conv3x3`` and ``dec0`` with their plain
PyTorch twins, patch-grid math, augmentation, dice, on-device resampling),
``data`` (the dataset builder and reader), ``pipeline`` and ``training``
(the train step and loop),
``inference`` (the sliding-window predictor, per-case and pipelined NIfTI
serving, the watch-directory server), ``parallel.spatial`` (the direct
whole-volume predictor), ``utils`` (copies of the JAX package's
numpy-only helpers, weights from the flax tree) and the ``train``,
``predict``, ``evaluate``, ``ensemble`` and ``serve`` entry points. Imports torch, never jax, and nothing of the JAX
package.
"""
