"""The port's raw crello schema (``flexdm_tpu_torch.data.crello``) against
the JAX package's (``flexdm_tpu.data.crello``): the same raw templates give
the same classes and the same fields, element by element, and ``load``
keeps and skips the same templates."""

import dataclasses
import json
import logging
import os
import re

import pytest

from flexdm_tpu.data import crello as jax_crello
from flexdm_tpu_torch.data import crello as port_crello
from tests.test_converter_and_schema import RAW_TEMPLATE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The modules of the port's ingestion path, which must not import JAX.
INGESTION = ("flexdm_tpu_torch/data/crello/__init__.py",
             "flexdm_tpu_torch/data/crello/schema.py",
             "flexdm_tpu_torch/utils/notebook.py",
             "tools/torch_build_crello_dataset.py",
             "tools/torch_scale_drill.py", "tools/torch_capstone.py",
             "tools/torch_build_notebooks.py")
JAX_IMPORT = re.compile(
    r"^\s*(from|import) (flexdm_tpu([. ]|$)|jax|flax|optax|orbax)", re.M)


def _element(**kw):
    return dict({"uuid": "e", "width": 10.0, "height": 5.0, "left": 1.0,
                 "top": 2.0}, **kw)


CASES = {
    "raw_template": RAW_TEMPLATE,
    # A V2 mask whose shape is text: maskType picks TextMaskElement.
    "mask_type": dict(RAW_TEMPLATE, template=[{"elements": [
        _element(type="maskElement", maskType="text", innerId=3),
        _element(type="maskElement", colors=[{"r": 1}]),
    ]}]),
    # V1 persistent group, an unknown element type, missing fields.
    "persist_group": dict(RAW_TEMPLATE, category=["food", "drink"],
                          template=[{"elements": [
                              {"type": "persistGroupElement", "elements": [
                                  _element(type="imageElement",
                                           filters={"blur": 0.5}),
                                  _element(type="brandNewElement"),
                              ]},
                              {"type": "textElement", "text": "x",
                               "position": {"left": 3, "top": 4}},
                          ]}, {"elements": [_element(type="svgElement")]}]),
    "no_pages": dict(RAW_TEMPLATE, template=None),
}


def _fields(obj):
    """Every field of a parsed template, the element classes by name."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: _fields(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, list):
        return [_fields(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _fields(v) for k, v in obj.items()}
    return obj


def _elements(module, raw):
    tpl = module.Template.from_dict(json.loads(json.dumps(raw)))
    return tpl, [
        (type(e).__name__, e.is_v2, e.x, e.y, e.to_dict())
        for e in tpl.iter_elements()
    ]


@pytest.mark.parametrize("case", sorted(CASES))
def test_from_dict_iter_elements_to_dict(case):
    jax_tpl, jax_els = _elements(jax_crello, CASES[case])
    port_tpl, port_els = _elements(port_crello, CASES[case])
    assert _fields(port_tpl) == _fields(jax_tpl)
    assert port_els == jax_els
    assert port_tpl.to_dict() == jax_tpl.to_dict()
    assert port_tpl.url == jax_tpl.url
    assert [len(list(p)) for p in port_tpl] == [len(list(p))
                                                for p in jax_tpl]


def test_raw_template_as_the_jax_tests_read_it():
    els = list(port_crello.Template.from_dict(RAW_TEMPLATE).iter_elements())
    assert [type(e) for e in els] == [
        port_crello.ColoredBackground, port_crello.TextElement,
        port_crello.GroupElement, port_crello.SVGElement]
    assert els[1].extra["someFutureField"] == 42
    assert els[1].is_v2 and not els[0].is_v2


@pytest.mark.parametrize("raw, message", [
    ({"originalId": 1, "type": "svgElement"}, "Old"),
    ({"type": "videoElement"}, "Video"),
])
def test_unsupported_elements_raise(raw, message):
    for module in (jax_crello, port_crello):
        with pytest.raises(NotImplementedError, match=message):
            module.BaseElement.from_dict(raw)


def test_element_types_match():
    assert {k: v.__name__ for k, v in port_crello.ElementTypes.items()} == \
        {k: v.__name__ for k, v in jax_crello.ElementTypes.items()}
    assert port_crello.__all__ == jax_crello.__all__


def test_load_keeps_and_skips_the_same_templates(tmp_path, caplog):
    rows = [
        RAW_TEMPLATE,
        dict(RAW_TEMPLATE, id="vid",
             template=[{"elements": [{"type": "videoElement"}]}]),
        dict(RAW_TEMPLATE, id="old",
             template=[{"elements": [{"originalId": 5}]}]),
        dict(RAW_TEMPLATE, id="nr", templateType="draft"),
        CASES["mask_type"],
        dict(CASES["persist_group"], id="pg"),
    ]
    for shard, part in (("a", rows[:3]), ("b", rows[3:])):
        with open(tmp_path / f"dump-{shard}.jsonl", "w") as f:
            for raw in part:
                f.write(json.dumps(raw) + "\n\n")  # blank lines are skipped
    pattern = str(tmp_path / "dump-*.jsonl")
    got = {}
    for module in (jax_crello, port_crello):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            templates = module.Template.load(pattern)
        got[module] = ([_fields(t) for t in templates],
                       [r.getMessage() for r in caplog.records
                        if r.getMessage().startswith("Skipped")],
                       module.Template.load(pattern, raw_format=True))
    assert got[port_crello][1] == got[jax_crello][1] == ["Skipped 2 templates"]
    assert got[port_crello][2] == got[jax_crello][2]
    assert len(got[port_crello][0]) == 3
    assert got[port_crello][0] == got[jax_crello][0]


@pytest.mark.parametrize("path", INGESTION)
def test_ingestion_modules_import_no_jax(path):
    with open(os.path.join(ROOT, path)) as f:
        source = f.read()
    assert not JAX_IMPORT.search(source), JAX_IMPORT.search(source)
