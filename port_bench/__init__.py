"""The benchmark of the PyTorch and CUDA port (``object_detector_tpu_torch``)."""
