"""Visualization / demo helpers: SVG builders, asset retrieval, rasterizer.

The port's own copy of ``flexdm_tpu/helpers``.  The rasterizer
(``rasterizer.py``) needs cairosvg or selenium, which the port does not
depend on: its ``Rasterizer`` raises where neither imports.
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
