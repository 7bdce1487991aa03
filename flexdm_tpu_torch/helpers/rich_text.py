"""Rich text span reconstruction for crello text elements.

The port's own copy of ``flexdm_tpu/helpers/rich_text.py``.  Counterpart
of the reference's styled-text rendering
(``helpers/svg_crello.py:265-433``): raw crello text elements carry
range-based style maps — ``colorMap`` / ``boldMap`` / ``italicMap`` (and an
optional ``lineMap``), each a list of ``{startIndex, endIndex, value}``
ranges over the text — which are expanded per character, grouped into runs
of constant style, split into lines, and emitted as ``<tspan>`` rows.

Works from plain dicts or objects with the same attributes (the raw
crello ``TextElement``); used by :class:`~.svg.SVGBuilder` when a raw
element (with text + style maps) accompanies the modeled one.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from itertools import groupby
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .svg import NS

Style = Tuple[Any, Any, Any]  # (color, bold, italic)


def _expand_map(ranges: Optional[List[Dict]], length: int, default=None):
    """Range list -> per-character value list (reference _make_map)."""
    values = [default] * length
    for r in ranges or []:
        for i in range(int(r["startIndex"]), min(int(r["endIndex"]) + 1, length)):
            values[i] = r.get("value")
    return values


def char_styles(element, length: int) -> List[Style]:
    get = (
        element.get
        if isinstance(element, dict)
        else lambda k, d=None: getattr(element, k, d)
    )
    return list(
        zip(
            _expand_map(get("colorMap"), length),
            _expand_map(get("boldMap"), length),
            _expand_map(get("italicMap"), length),
        )
    )


def split_lines(text: str, line_map: Optional[List[Dict]]) -> List[Tuple[int, int]]:
    """(start, end) per line: explicit lineMap or newline splits."""
    if line_map:
        return [
            (int(l["startIndex"]), int(l["endIndex"]) + 1) for l in line_map
        ]
    lines = []
    start = 0
    for i, ch in enumerate(text):
        if ch == "\n":
            lines.append((start, i))
            start = i + 1
    lines.append((start, len(text)))
    return lines


def iter_spans(
    text: str, styles: List[Style], start: int, end: int
) -> Iterator[Dict[str, Any]]:
    """Runs of constant style within [start, end)."""
    offset = start
    for style, run in groupby(styles[start:end]):
        n = len(list(run))
        color, bold, italic = style
        yield {
            "text": text[offset : offset + n],
            "color": color,
            "bold": bool(bold),
            "italic": bool(italic),
        }
        offset += n


def rich_text_node(
    parent,
    element,
    *,
    x: float,
    y: float,
    width: float,
    height: float,
    font_family: str = "sans-serif",
    default_fill: str = "#000",
    opacity: float = 1.0,
):
    """Append an ``<svg><text>`` with per-line/per-run ``<tspan>`` styling.

    ``element`` supplies ``text`` and the style maps; geometry comes from the
    modeled attributes (already in the unit canvas space).
    """
    get = (
        element.get
        if isinstance(element, dict)
        else lambda k, d=None: getattr(element, k, d)
    )
    text_str = get("text") or ""
    styles = char_styles(element, len(text_str))
    lines = split_lines(text_str, get("lineMap"))
    n_lines = max(len(lines), 1)
    line_height = height / n_lines

    container = ET.SubElement(
        parent,
        ET.QName(NS["svg"], "svg"),
        {
            "x": str(x),
            "y": str(y),
            "width": str(width),
            "height": str(height),
            "overflow": "hidden",
        },
    )
    node = ET.SubElement(
        container,
        ET.QName(NS["svg"], "text"),
        {
            "font-size": str(line_height),
            "font-family": str(font_family),
            "opacity": str(opacity),
        },
    )
    if get("underline"):
        node.set("text-decoration", "underline")

    for li, (start, end) in enumerate(lines):
        first = True
        for span in iter_spans(text_str, styles, start, end):
            tspan = ET.SubElement(node, ET.QName(NS["svg"], "tspan"))
            if first:
                tspan.set("x", "0")
                tspan.set("y", str(line_height * (li + 1)))
                first = False
            tspan.set("fill", str(span["color"] or default_fill))
            if span["bold"]:
                tspan.set("font-weight", "bold")
            if span["italic"]:
                tspan.set("font-style", "italic")
            text = span["text"]
            if get("capitalize"):
                text = text.upper()
            tspan.text = text
        if first:  # empty line keeps vertical rhythm
            tspan = ET.SubElement(node, ET.QName(NS["svg"], "tspan"))
            tspan.set("x", "0")
            tspan.set("y", str(line_height * (li + 1)))
            tspan.text = " "
    return container
