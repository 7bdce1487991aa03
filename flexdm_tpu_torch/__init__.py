"""flexdm_tpu_torch: the PyTorch / CUDA port of flexdm_tpu's serving path."""

__version__ = "0.1.0"
