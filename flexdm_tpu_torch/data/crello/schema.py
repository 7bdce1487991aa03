"""Dataclass model of raw crello JSON templates (offline ingestion).

The port's own copy of ``flexdm_tpu/data/crello/schema.py`` (same classes,
same dispatch, same tolerant binding), so the port's dataset builder
(``tools/torch_build_crello_dataset.py``) imports nothing of the JAX
package.

Counterpart of reference ``src/mfp/mfp/data/crello/schema.py``: the crawled
crello corpus is JSONL of design templates; each template has pages of typed
elements (svg / image / mask / text-mask / text / colored-background /
group), in two generations — "V1" and "V2", distinguished by the presence of
an ``innerId`` field (reference schema.py:1-26).  Old ``originalId``
templates and video elements are rejected (schema.py:40-44).

The reference binds every dump field strictly through ``dacite`` (425 lines
of per-variant field lists).  This model is deliberately tolerant instead:
the modeled attributes are typed dataclass fields, and everything else the
dump carries lands in ``extra`` — crawled schemas drift, and the framework
only consumes the modeled subset (geometry, type, text styling, colors).
Used only by offline preprocessing and rich text rendering, never in the
training path.
"""

from __future__ import annotations

import dataclasses
import glob as globlib
import json
import logging
from typing import Any, Dict, Iterator, List, Optional, Union

logger = logging.getLogger(__name__)


def _build(cls, value: Dict[str, Any]):
    """Instantiate ``cls`` from a raw dict: typed fields by name, the rest
    into ``extra`` (replaces dacite's strict binding, schema.py:49-58)."""
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in value.items() if k in names and k != "extra"}
    extra = {k: v for k, v in value.items() if k not in names}
    missing = names - set(kwargs) - {"extra"}
    for name in missing:
        kwargs[name] = None
    obj = cls(extra=extra, **kwargs)
    return obj


@dataclasses.dataclass
class BaseElement:
    """Common element attributes (reference schema.py:64-78)."""

    type: Optional[str] = None
    uuid: Optional[str] = None
    width: Optional[float] = None
    height: Optional[float] = None
    angle: Optional[float] = None
    opacity: Optional[float] = None
    position: Optional[Dict[str, float]] = None
    left: Optional[float] = None
    top: Optional[float] = None
    innerId: Optional[Union[str, int]] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def is_v2(self) -> bool:
        return self.innerId is not None

    @property
    def x(self) -> Optional[float]:
        if self.left is not None:
            return self.left
        if self.position:
            return self.position.get("x", self.position.get("left"))
        return None

    @property
    def y(self) -> Optional[float]:
        if self.top is not None:
            return self.top
        if self.position:
            return self.position.get("y", self.position.get("top"))
        return None

    @classmethod
    def from_dict(cls, value: Dict[str, Any]) -> "BaseElement":
        """Dispatch to the concrete element type (schema.py:38-58)."""
        if "originalId" in value:
            raise NotImplementedError("Old (originalId) format not supported.")
        type_ = value.get("type")
        if type_ == "videoElement":
            raise NotImplementedError("Video not supported.")
        true_class = ElementTypes.get(type_, cls)
        if true_class is MaskElement and value.get("maskType"):
            true_class = TextMaskElement
        obj = _build(true_class, value)
        if isinstance(obj, (GroupElement, PersistGroupElement)) and obj.elements:
            obj.elements = [
                e if isinstance(e, BaseElement) else BaseElement.from_dict(e)
                for e in obj.elements
            ]
        return obj

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(d.pop("extra", {}))
        return d


@dataclasses.dataclass
class SVGElement(BaseElement):
    """Vector asset with recolorable layers (schema.py:104-128)."""

    colors: Optional[List[Dict[str, Any]]] = None
    mediaId: Optional[str] = None
    url: Optional[str] = None


@dataclasses.dataclass
class ImageElement(BaseElement):
    """Raster asset (schema.py:131-179)."""

    filters: Optional[Dict[str, float]] = None
    mediaId: Optional[str] = None
    src: Optional[str] = None
    url: Optional[str] = None


@dataclasses.dataclass
class MaskElement(BaseElement):
    """Image masked by a vector shape (schema.py:219-253)."""

    filters: Optional[Dict[str, float]] = None
    colors: Optional[List[Dict[str, Any]]] = None
    maskType: Optional[str] = None
    mediaId: Optional[str] = None


@dataclasses.dataclass
class TextMaskElement(MaskElement):
    """V2 mask whose shape is text (schema.py:256-258)."""


@dataclasses.dataclass
class TextElement(BaseElement):
    """Styled text run (schema.py:182-216)."""

    text: Optional[str] = None
    font: Optional[str] = None
    fontSize: Optional[Union[float, str]] = None
    capitalize: Optional[bool] = None
    underline: Optional[bool] = None
    lineHeight: Optional[Union[float, str]] = None
    letterSpacing: Optional[Union[float, str]] = None
    alignHorizontal: Optional[str] = None
    alignVertical: Optional[str] = None
    colorMap: Optional[Any] = None
    boldMap: Optional[Any] = None
    italicMap: Optional[Any] = None


@dataclasses.dataclass
class ColoredBackground(BaseElement):
    """Full-canvas fill (schema.py:261-284)."""

    color: Optional[Union[str, List[int], Dict[str, Any]]] = None


@dataclasses.dataclass
class GroupElement(BaseElement):
    """V2 nested group of elements (schema.py:287-305)."""

    elements: Optional[List[BaseElement]] = None

    def __iter__(self) -> Iterator[BaseElement]:
        yield from self.elements or []


@dataclasses.dataclass
class PersistGroupElement(GroupElement):
    """V1 persistent group (schema.py:308-318)."""


# type-name -> concrete class (reference keys on (type, has_innerId) only to
# pick the V1/V2 field list; here variants share one tolerant class and the
# generation is exposed via ``is_v2``).  Reference schema.py:412-425.
ElementTypes: Dict[Optional[str], type] = {
    "svgElement": SVGElement,
    "imageElement": ImageElement,
    "maskElement": MaskElement,
    "textElement": TextElement,
    "coloredBackground": ColoredBackground,
    "groupElement": GroupElement,
    "persistGroupElement": PersistGroupElement,
}


@dataclasses.dataclass
class Page:
    """One artboard of a template (reference schema.py:321-334)."""

    elements: Optional[List[BaseElement]] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __iter__(self) -> Iterator[BaseElement]:
        yield from self.elements or []

    @classmethod
    def from_dict(cls, value: Dict[str, Any]) -> "Page":
        page = _build(cls, value)
        page.elements = [
            BaseElement.from_dict(e) for e in (page.elements or [])
        ]
        return page


@dataclasses.dataclass
class Template:
    """A full crello design template (reference schema.py:337-409)."""

    id: Optional[str] = None
    name: Optional[str] = None
    width: Optional[Union[float, str]] = None
    height: Optional[Union[float, str]] = None
    pixelWidth: Optional[float] = None
    pixelHeight: Optional[float] = None
    category: Optional[Union[str, List[str]]] = None
    group: Optional[str] = None
    format: Optional[str] = None
    templateType: Optional[str] = None
    template: Optional[List[Page]] = None
    suitability: Optional[List[str]] = None
    status: Optional[str] = None
    createdAt: Optional[int] = None
    updatedAt: Optional[int] = None
    v2: Optional[bool] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def url(self) -> str:
        return "https://crello.com/artboard/?template=" + str(self.id)

    def __iter__(self) -> Iterator[Page]:
        yield from self.template or []

    def iter_elements(self) -> Iterator[BaseElement]:
        """Flatten the first page, descending into groups
        (reference schema.py:396-401)."""
        if not self.template:
            return
        for element in self.template[0]:
            yield element
            if isinstance(element, (GroupElement, PersistGroupElement)):
                yield from element

    @classmethod
    def from_dict(cls, value: Dict[str, Any]) -> "Template":
        tpl = _build(cls, value)
        tpl.template = [Page.from_dict(p) for p in (tpl.template or [])]
        return tpl

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(d.pop("extra", {}))
        return d

    @staticmethod
    def load(path: str, raw_format: bool = False) -> List:
        """Load templates from JSONL file(s) matched by a glob
        (reference schema.py:386-409): non-"regular" templates are dropped,
        unsupported (old-format / video) ones are skipped with a count."""
        out: List = []
        skipped = 0
        for file_name in globlib.glob(path):
            with open(file_name) as f:
                for line in f:
                    if not line.strip():
                        continue
                    value = json.loads(line)
                    if raw_format:
                        out.append(value)
                        continue
                    if value.get("templateType") != "regular":
                        continue
                    try:
                        out.append(Template.from_dict(value))
                    except NotImplementedError:
                        skipped += 1
        if skipped:
            logger.info("Skipped %d templates", skipped)
        return out
