"""SVG rendering of unbatched documents (rico + crello).

The port's own copy of ``flexdm_tpu/helpers/svg.py`` (the same SVG strings
for the same documents).  Counterpart of reference ``helpers/svg_rico.py``
and the core of ``helpers/svg_crello.py``: render a document dict (as produced by
``DatasetSpec.unbatch``) to an SVG string.  Elements are drawn in a unit
viewBox scaled to the canvas size; fills come from a per-vocabulary colormap
(or the element's own RGB for ``key='color'``), retrieved images/texts are
embedded when a retriever database is supplied, and text elements render a
placeholder (or retrieved) string clipped to their box.

The reference's crello variant additionally reconstructed rich per-character
styling from pickled ``colorMap``/``boldMap`` assets shipped with the raw
dataset (reference svg_crello.py:265-433); those assets are data-release
specific — supply the released ``fonts.css`` via ``fonts_css`` for real font
faces, and per-character span styling can be layered on the returned SVG.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Any, Dict, Optional

NS = {
    "svg": "http://www.w3.org/2000/svg",
    "xlink": "http://www.w3.org/1999/xlink",
}
ET.register_namespace("", NS["svg"])
ET.register_namespace("xlink", NS["xlink"])

PLACEHOLDER_TEXT = "TEXT " * 10

# 20 visually-distinct fills used when matplotlib is unavailable.
_FALLBACK_PALETTE = [
    "#1f77b4", "#aec7e8", "#ff7f0e", "#ffbb78", "#2ca02c",
    "#98df8a", "#d62728", "#ff9896", "#9467bd", "#c5b0d5",
    "#8c564b", "#c49c94", "#e377c2", "#f7b6d2", "#7f7f7f",
    "#c7c7c7", "#bcbd22", "#dbdb8d", "#17becf", "#9edae5",
]


def rico_component_colormap() -> Dict[str, str]:
    """Canonical rico component colors (counterpart of the reference's
    ``data/component_legend.json``)."""
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "rico_legend.json")
    with open(path) as f:
        legend = json.load(f)
    return {name: entry["hex"] for name, entry in legend.items()}


def load_fonts_css(path: str) -> Optional[str]:
    """Load the crello data release's ``fonts.css`` (``@font-face`` links to
    the hosted .ttf files; reference ``svg_crello.py:130-147`` inlines the
    same file into every SVG).

    ``path`` may be the css file itself or a directory containing
    ``fonts.css`` (e.g. the crello data dir).  Returns None when absent, so
    callers can pass the result straight to ``SVGBuilder(fonts_css=...)``.
    """
    import os

    if os.path.isdir(path):
        path = os.path.join(path, "fonts.css")
    if not os.path.isfile(path):
        return None
    with open(path, encoding="utf-8") as f:
        return f.read()


def make_colormap(vocabulary, cmap_name: Optional[str] = None) -> Dict[str, str]:
    """label -> css color for a vocabulary list (reference svg_rico.py:143-154)."""
    try:
        import matplotlib

        cmap = matplotlib.colormaps.get_cmap(cmap_name or "tab20").resampled(
            len(vocabulary)
        )
        return {
            label: "rgb(%g,%g,%g)" % tuple(int(x * 255) for x in c[:3])
            for label, c in zip(vocabulary, cmap(range(len(vocabulary))))
        }
    except Exception:
        return {
            label: _FALLBACK_PALETTE[i % len(_FALLBACK_PALETTE)]
            for i, label in enumerate(vocabulary)
        }


class SVGBuilder:
    """Render unbatched documents to SVG strings.

    Args:
      key: which element attribute drives the fill color ('type', 'color',
        'icon', ...).
      colormap: explicit label -> color mapping; generated from ``vocab``
        when omitted.
      vocab: vocabulary list used to auto-build the colormap (pass
        ``DatasetSpec.vocabs[key].tokens``).
      canvas_width/height: fallback canvas size when the document carries
        none (rico).
      max_width/height: clamp the rendered size, preserving aspect.
      opacity: global fill opacity multiplier for rects.
      image_db / text_db: optional retrievers (see helpers.retrieve); when an
        element satisfies the retriever's condition, its embedding is mapped
        to a real asset and rendered.
      render_text: draw placeholder/retrieved text for text elements.
    """

    def __init__(
        self,
        key: str = "type",
        colormap: Optional[Dict[str, str]] = None,
        vocab=None,
        canvas_width: Optional[int] = None,
        canvas_height: Optional[int] = None,
        max_width: Optional[int] = None,
        max_height: Optional[int] = None,
        opacity: float = 0.5,
        image_db=None,
        text_db=None,
        render_text: bool = False,
        fonts_css: Optional[str] = None,
    ):
        self.key = key
        if colormap is None and vocab is not None and key != "color":
            colormap = make_colormap(list(vocab))
        self.colormap = colormap or {}
        self.canvas_width = canvas_width or 256
        self.canvas_height = canvas_height or 256
        self.max_width = max_width
        self.max_height = max_height
        self.opacity = opacity
        self.image_db = image_db
        self.text_db = text_db
        self.render_text = render_text
        self.fonts_css = fonts_css

    # ------------------------------------------------------------------
    def __call__(self, document: Dict[str, Any]) -> str:
        w, h = self.compute_canvas_size(document)
        root = ET.Element(
            ET.QName(NS["svg"], "svg"),
            {
                "width": str(w),
                "height": str(h),
                "viewBox": "0 0 1 1",
                "style": "background-color: #EEE",
                "preserveAspectRatio": "none",
            },
        )
        if self.fonts_css:
            style = ET.SubElement(root, ET.QName(NS["svg"], "style"))
            style.text = self.fonts_css

        for element in document.get("elements", []):
            fill = self._fill(element)
            node = None

            if self.image_db is not None and self._matches(
                element, self.image_db.condition
            ):
                url = self.image_db.search(element[self.image_db.value])
                if url:
                    node = self._image(root, element, url)

            if node is None and self.render_text and self._is_text(element):
                raw = element.get("raw")  # crello TextElement with style maps
                if raw is not None and (
                    (raw.get("text") if isinstance(raw, dict)
                     else getattr(raw, "text", None))
                ):
                    from .rich_text import rich_text_node

                    node = rich_text_node(
                        root,
                        raw,
                        x=element["left"],
                        y=element["top"],
                        width=element["width"],
                        height=element["height"],
                        font_family=element.get("font_family", "sans-serif"),
                        default_fill=fill,
                        opacity=float(element.get("opacity", 1.0)),
                    )
                else:
                    text = PLACEHOLDER_TEXT
                    if self.text_db is not None and self._matches(
                        element, self.text_db.condition
                    ):
                        text = (
                            self.text_db.search(element[self.text_db.value])
                            or text
                        )
                    node = self._text(root, element, fill, text)

            if node is None:
                node = self._rect(root, element, fill)

            hidden = {self.image_db.value if self.image_db else None,
                      self.text_db.value if self.text_db else None}
            title = ET.SubElement(node, ET.QName(NS["svg"], "title"))
            title.text = str({k: v for k, v in element.items() if k not in hidden})
        return ET.tostring(root).decode("utf-8")

    # ------------------------------------------------------------------
    def compute_canvas_size(self, document):
        w = document.get("canvas_width", self.canvas_width)
        h = document.get("canvas_height", self.canvas_height)
        scale = 1.0
        if self.max_width is not None:
            scale = min(self.max_width / w, scale)
        if self.max_height is not None:
            scale = min(self.max_height / h, scale)
        return w * scale, h * scale

    @staticmethod
    def _matches(element, condition) -> bool:
        return (
            condition is not None
            and element.get(condition["key"]) in condition["values"]
        )

    @staticmethod
    def _is_text(element) -> bool:
        t = str(element.get("type", ""))
        return t == "textElement" or t.lower().startswith("text")

    def _fill(self, element) -> str:
        if self.key == "color":
            rgb = element.get("color")
            if rgb is not None:
                return "rgb(%g,%g,%g)" % tuple(int(v) for v in rgb)
            return "none"
        return self.colormap.get(element.get(self.key), "none")

    @staticmethod
    def _geometry(element) -> Dict[str, str]:
        return {
            "x": str(element["left"]),
            "y": str(element["top"]),
            "width": str(element["width"]),
            "height": str(element["height"]),
        }

    def _rect(self, parent, element, fill):
        attrs = self._geometry(element)
        attrs.update(
            fill=str(fill),
            opacity=str(float(element.get("opacity", 1.0)) * self.opacity),
        )
        return ET.SubElement(parent, ET.QName(NS["svg"], "rect"), attrs)

    def _image(self, parent, element, url):
        attrs = self._geometry(element)
        attrs[ET.QName(NS["xlink"], "href")] = url
        attrs["opacity"] = str(element.get("opacity", 1.0))
        attrs["preserveAspectRatio"] = "none"
        return ET.SubElement(parent, ET.QName(NS["svg"], "image"), attrs)

    def _text(self, parent, element, fill, text):
        opacity = float(element.get("opacity", 1.0))
        # faint box behind the text
        box = self._geometry(element)
        box.update(fill=str(fill), opacity=str(opacity * 0.3))
        ET.SubElement(parent, ET.QName(NS["svg"], "rect"), box)
        # clip region so overflow is hidden
        clip_attrs = self._geometry(element)
        clip_attrs["overflow"] = "hidden"
        clip = ET.SubElement(parent, ET.QName(NS["svg"], "svg"), clip_attrs)
        attrs = {
            "x": "0",
            "y": str(element["height"]),
            "opacity": str(opacity * 0.7),
            "font-size": str(element["height"]),
            "fill": str(fill),
            "style": "vertical-align:top;font-stretch:condensed;",
        }
        if element.get("font_family"):
            attrs["font-family"] = str(element["font_family"])
        node = ET.SubElement(clip, ET.QName(NS["svg"], "text"), attrs)
        node.text = text
        return node
