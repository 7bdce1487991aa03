"""Visualization / demo helpers: SVG builders and asset retrieval.

The port's own copy of ``flexdm_tpu/helpers`` (the rasterizer, which needs
selenium or cairosvg, is not carried over).
"""

from .retrieve import ImageRetriever, TextRetriever, make_data_uri
from .svg import SVGBuilder, make_colormap

__all__ = [
    "ImageRetriever",
    "SVGBuilder",
    "TextRetriever",
    "make_colormap",
    "make_data_uri",
]
