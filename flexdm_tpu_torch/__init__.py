"""flexdm_tpu_torch: the PyTorch / CUDA port of flexdm_tpu (serving and
training of the oneshot MFP model)."""

__version__ = "0.1.0"
