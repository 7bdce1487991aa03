"""SVG -> PNG rasterization.

The port's own copy of ``flexdm_tpu/helpers/rasterizer.py`` (reference
``helpers/rasterizer.py``).  The reference drives headless Chrome through
selenium; ``cairosvg`` is used instead where it imports.  Neither is a
dependency of the port, so the backend is gated: constructing a
:class:`Rasterizer` raises ``RuntimeError`` when neither imports.
:func:`get_svg_size` needs neither.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import List, Tuple


def get_svg_size(input_path: str) -> Tuple[int, int]:
    """``(width, height)`` of an SVG file, each rounded up to an integer."""
    root = ET.parse(input_path).getroot()
    return (
        math.ceil(float(root.get("width"))),
        math.ceil(float(root.get("height"))),
    )


class Rasterizer:
    """Rasterize an SVG file to PNG using the best available backend:
    cairosvg, then selenium with headless Chrome."""

    def __init__(self):
        self._backend = None
        try:
            import cairosvg  # noqa: F401

            self._backend = "cairosvg"
            return
        except ImportError:
            pass
        try:
            from selenium import webdriver  # noqa: F401
            from selenium.webdriver.chrome.options import Options

            options = Options()
            for arg in (
                "--headless",
                "--hide-scrollbars",
                "--no-sandbox",
                "--disable-dev-shm-usage",
            ):
                options.add_argument(arg)
            self._chrome_options = options
            self._backend = "selenium"
            return
        except ImportError:
            pass
        raise RuntimeError(
            "No rasterization backend available: install cairosvg or "
            "selenium + headless Chrome."
        )

    def __call__(self, svg_path: str, png_path: str, size: List[int]) -> None:
        """Write ``svg_path`` rendered at ``size`` = ``[width, height]`` to
        ``png_path``."""
        assert len(size) == 2
        if self._backend == "cairosvg":
            import cairosvg

            cairosvg.svg2png(
                url=str(svg_path),
                write_to=str(png_path),
                output_width=size[0],
                output_height=size[1],
            )
        else:
            from selenium import webdriver

            driver = webdriver.Chrome(options=self._chrome_options)
            try:
                driver.set_window_size(*size)
                driver.get(f"file://{svg_path}")
                driver.get_screenshot_as_file(str(png_path))
            finally:
                driver.quit()
