"""The benchmark of the PyTorch and CUDA port (``vag_nmt_tpu_torch``): its
harness, yardstick and plain reference. See README.md."""
