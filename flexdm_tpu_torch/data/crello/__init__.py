"""Raw crello template ingestion (offline preprocessing layer): the port's
copy of ``flexdm_tpu/data/crello``."""

from .schema import (
    BaseElement,
    ColoredBackground,
    ElementTypes,
    GroupElement,
    ImageElement,
    MaskElement,
    Page,
    PersistGroupElement,
    SVGElement,
    Template,
    TextElement,
    TextMaskElement,
)

__all__ = [
    "BaseElement",
    "ColoredBackground",
    "ElementTypes",
    "GroupElement",
    "ImageElement",
    "MaskElement",
    "Page",
    "PersistGroupElement",
    "SVGElement",
    "Template",
    "TextElement",
    "TextMaskElement",
]
