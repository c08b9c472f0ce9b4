"""The benchmark of ``fetal_mri_segmentation_tpu_torch`` on the H100:
``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (see ``perfbench/README.md``)."""
