"""The MFP model of the port: encoder, transformer blocks, decoder heads."""

from .mfp import MFPModel, forward_eval

__all__ = ["MFPModel", "forward_eval"]
