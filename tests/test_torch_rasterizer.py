"""The port's rasterizer helpers (``flexdm_tpu_torch/helpers/rasterizer.py``)
against the JAX package's (``flexdm_tpu/helpers/rasterizer.py``): the size
of an SVG the port's ``SVGBuilder`` wrote, and the refusal of a
``Rasterizer`` where no backend imports."""

import sys

import pytest

from flexdm_tpu.helpers import rasterizer as jax_rasterizer
from flexdm_tpu_torch.helpers import rasterizer, svg

DOCUMENT = {
    "canvas_width": 300.5,
    "canvas_height": 401.25,
    "elements": [
        {"type": "imageElement", "left": 0.1, "top": 0.2, "width": 0.3,
         "height": 0.4},
        {"type": "svgElement", "left": 0.5, "top": 0.05, "width": 0.25,
         "height": 0.5},
    ],
}


@pytest.mark.parametrize("max_side", [None, 180, 97])
def test_get_svg_size_matches_jax(tmp_path, max_side):
    builder = svg.SVGBuilder(vocab=["imageElement", "svgElement"],
                             max_width=max_side, max_height=max_side)
    path = tmp_path / "document.svg"
    path.write_text(builder(DOCUMENT))
    got = rasterizer.get_svg_size(str(path))
    assert got == jax_rasterizer.get_svg_size(str(path))
    assert all(isinstance(x, int) and x > 0 for x in got)


def test_rasterizer_without_a_backend_raises(monkeypatch):
    """With cairosvg and selenium hidden (whatever this machine has), both
    packages' ``Rasterizer()`` raise the same ``RuntimeError``."""
    for name in ("cairosvg", "selenium", "selenium.webdriver",
                 "selenium.webdriver.chrome.options"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(RuntimeError) as ours:
        rasterizer.Rasterizer()
    with pytest.raises(RuntimeError) as theirs:
        jax_rasterizer.Rasterizer()
    assert str(ours.value) == str(theirs.value)
    assert "cairosvg" in str(ours.value) and "selenium" in str(ours.value)
