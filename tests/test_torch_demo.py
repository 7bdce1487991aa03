"""The port's demo renderer (``flexdm_tpu_torch/demo.py`` and
``flexdm_tpu_torch/helpers``) against the JAX package's
(``flexdm_tpu/demo.py``, ``flexdm_tpu/helpers``): the same documents give
the same SVG strings, the same store gives the same retrievals, and the
same weights and batch give the same predictions (within 1e-5)."""

import json
import os
import subprocess
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from flexdm_tpu import demo as jax_demo  # noqa: E402
from flexdm_tpu.data import DatasetSpec as JaxSpec  # noqa: E402
from flexdm_tpu.helpers import retrieve as jax_retrieve  # noqa: E402
from flexdm_tpu.helpers import rich_text as jax_rich_text  # noqa: E402
from flexdm_tpu.helpers import svg as jax_svg  # noqa: E402
from flexdm_tpu.models import forward_eval as jax_forward_eval  # noqa: E402
from flexdm_tpu_torch import demo  # noqa: E402
from flexdm_tpu_torch.convert import save_weights  # noqa: E402
from flexdm_tpu_torch.data import DatasetSpec, example_proto, tfrecord  # noqa: E402
from flexdm_tpu_torch.helpers import retrieve, rich_text, svg  # noqa: E402
from tests._torch_parity import (  # noqa: E402
    model_pair,
    numpy_batch,
    random_masks,
    to_jax,
    to_numpy,
    to_torch,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SVG = "{http://www.w3.org/2000/svg}"
N = 4  # documents on a page
TOL = dict(rtol=1e-5, atol=1e-5)
FONTS_CSS = ("@font-face {\n  font-family: Font1;\n"
             "  src: url(https://example.com/font1.ttf)\n}\n")
RAW_TEXT = {
    "text": "Big Sale\nToday only",
    "colorMap": [{"startIndex": 0, "endIndex": 2, "value": "#ff0000"}],
    "boldMap": [{"startIndex": 4, "endIndex": 7, "value": True}],
    "italicMap": [{"startIndex": 9, "endIndex": 13, "value": True}],
    "capitalize": True,
    "underline": True,
}


def _items(dataset, data_dir):
    spec = DatasetSpec(dataset, data_dir)
    return spec, spec.unbatch(next(iter(spec.make_dataset("test",
                                                          batch_size=6))))


@pytest.mark.parametrize("dataset, key", [
    ("crello", "type"), ("crello", "color"), ("rico", "type")])
def test_svg_builder_matches_jax(dataset, key, request):
    """Unbatched items, placeholder text and a rich-text element with
    style maps, fonts.css inlined: the port's SVG strings are JAX's (fills
    from the type colormap, or from crello's own colors)."""
    spec, items = _items(dataset, request.getfixturevalue(f"{dataset}_dir"))
    items[0]["elements"][0]["type"] = "textElement"
    items[0]["elements"][0]["raw"] = RAW_TEXT
    if len(items[1]["elements"]) > 1:
        items[1]["elements"][1]["type"] = "textElement"
        items[1]["elements"][1]["font_family"] = "Font1"
    kwargs = dict(key=key, vocab=spec.vocabs["type"].tokens, max_width=180,
                  max_height=180, render_text=True, fonts_css=FONTS_CSS)
    ours, theirs = svg.SVGBuilder(**kwargs), jax_svg.SVGBuilder(**kwargs)
    assert ours.colormap == theirs.colormap
    for i, item in enumerate(items):
        got = ours(item)
        assert got == theirs(item), i
        root = ET.fromstring(got)
        assert root.find(f"{SVG}style").text == FONTS_CSS
    assert "<tspan" in ours(items[0])


def test_svg_module_helpers_match_jax(tmp_path):
    (tmp_path / "fonts.css").write_text(FONTS_CSS)
    assert svg.load_fonts_css(str(tmp_path)) == FONTS_CSS
    assert svg.load_fonts_css(str(tmp_path / "fonts.css")) == FONTS_CSS
    assert svg.load_fonts_css(str(tmp_path / "missing")) is None
    assert svg.rico_component_colormap() == jax_svg.rico_component_colormap()
    labels = [f"label{i}" for i in range(25)]
    assert svg.make_colormap(labels) == jax_svg.make_colormap(labels)
    assert svg._FALLBACK_PALETTE == jax_svg._FALLBACK_PALETTE


def test_make_colormap_fallback_palette(monkeypatch):
    """Without matplotlib (as on a machine that lacks it), the fallback
    palette, as JAX's."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    labels = [f"l{i}" for i in range(23)]
    got = svg.make_colormap(labels)
    assert got == jax_svg.make_colormap(labels)
    assert got["l0"] == "#1f77b4" and got["l20"] == "#1f77b4"


@pytest.mark.parametrize("line_map", [None, [
    {"startIndex": 0, "endIndex": 3}, {"startIndex": 4, "endIndex": 18}]])
def test_rich_text_matches_jax(line_map):
    raw = dict(RAW_TEXT, lineMap=line_map)
    text = raw["text"]
    styles = rich_text.char_styles(raw, len(text))
    assert styles == jax_rich_text.char_styles(raw, len(text))
    lines = rich_text.split_lines(text, line_map)
    assert lines == jax_rich_text.split_lines(text, line_map)
    for start, end in lines:
        assert list(rich_text.iter_spans(text, styles, start, end)) == list(
            jax_rich_text.iter_spans(text, styles, start, end))

    def render(module):
        parent = ET.Element("svg")
        module.rich_text_node(parent, raw, x=0.1, y=0.2, width=0.5,
                              height=0.3, font_family="Font1",
                              default_fill="#123", opacity=0.8)
        return ET.tostring(parent)

    assert render(rich_text) == render(jax_rich_text)


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    """A synthetic crello-images / crello-texts store and its assets: 10
    entries in 5 records, one loader batch padded past them (the padding
    rows must not reach the index)."""
    root = tmp_path_factory.mktemp("store")
    rng = np.random.default_rng(0)
    hashes = [f"hash{i}" for i in range(10)]
    embs = rng.normal(size=(10, 512)).astype(np.float32)
    for name, key, value in (("images_store", "image_hash", "image_embedding"),
                             ("texts_store", "text_hash", "text_embedding")):
        d = root / name
        os.makedirs(d / "images")
        os.makedirs(d / "texts")
        with tfrecord.RecordWriter(
                str(d / "train-00000-of-00001.tfrecord")) as w:
            for i in range(0, 10, 2):  # two entries per record
                w.write(example_proto.encode_sequence_example({}, {
                    key: [[h.encode()] for h in hashes[i:i + 2]],
                    value: [[float(x) for x in row] for row in embs[i:i + 2]],
                }))
        for i, h in enumerate(hashes):
            (d / "images" / f"{h}.png").write_bytes(
                bytes.fromhex("89504e470d0a1a0a") + bytes([i]) * 8)
            (d / "texts" / f"{h}.txt").write_text(f"text number {i}")
    return str(root / "images_store"), str(root / "texts_store"), embs


def test_retrievers_match_jax(store_dir):
    img_dir, txt_dir, embs = store_dir
    queries = embs[[3, 9, 0]] + 0.05 * np.random.default_rng(1).normal(
        size=(3, 512)).astype(np.float32)
    for ours, theirs in (
        (retrieve.ImageRetriever(img_dir), jax_retrieve.ImageRetriever(img_dir)),
        (retrieve.TextRetriever(txt_dir), jax_retrieve.TextRetriever(txt_dir)),
    ):
        ours.build()
        theirs.build()
        np.testing.assert_array_equal(ours._labels, theirs._labels)
        np.testing.assert_array_equal(ours._data, theirs._data)
        assert len(ours._labels) == 10
        np.testing.assert_array_equal(ours.search_indices(queries, k=3),
                                      theirs.search_indices(queries, k=3))
        for q in queries:
            assert ours.search(q) == theirs.search(q)
            assert ours.search(q, k=2) == theirs.search(q, k=2)
    assert retrieve.TextRetriever(txt_dir).search(embs[9]) == "text number 9"
    png = os.path.join(img_dir, "images", "hash3.png")
    assert retrieve.make_data_uri(png) == jax_retrieve.make_data_uri(png)


@pytest.mark.parametrize("dataset", ["crello", "rico"])
def test_masked_input_view_matches_jax(dataset, request):
    spec = JaxSpec(dataset, request.getfixturevalue(f"{dataset}_dir"))
    schema = spec.schema
    batch = numpy_batch(spec, N)
    masks = random_masks(schema, batch, seed=3)
    want = jax_demo.masked_input_view(schema, to_jax(batch), to_jax(masks))
    got = demo.masked_input_view(schema, to_torch(batch), to_torch(masks))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(to_numpy(got)[k], np.asarray(want[k]),
                                      err_msg=k)


def _write_job(root, dataset, data_dir, port_model, **config):
    os.makedirs(os.path.join(root, "checkpoints"))
    args = dict(dataset_name=dataset, data_dir=data_dir, latent_dim=32,
                num_blocks=2, num_heads=4, **config)
    with open(os.path.join(root, "args.json"), "w") as f:
        json.dump(args, f)
    save_weights(os.path.join(root, "checkpoints", "best.torch.npz"),
                 port_model)
    return root


@pytest.fixture(scope="module", params=["crello", "rico"])
def job(request, tmp_path_factory):
    """A port job with random weights (latent 32, 2 blocks), its JAX twin
    with the same weights, and the first test batch; rico's conditions
    on the task id."""
    dataset = request.param
    data_dir = request.getfixturevalue(f"{dataset}_dir")
    spec = JaxSpec(dataset, data_dir)
    batch = numpy_batch(spec, N)
    config = {"context": "id"} if dataset == "rico" else {}
    jax_model, params, port_model = model_pair(spec.schema, batch, **config)
    root = _write_job(str(tmp_path_factory.mktemp(f"demo_{dataset}")),
                      dataset, data_dir, port_model, **config)
    return dict(dir=root, spec=spec, batch=batch, jax_model=jax_model,
                params=params)


def _page_cells(path):
    """The page's rows, each a list of its parsed SVG roots."""
    page = open(path).read()
    rows = page.split("<tr>")[2:]  # after the header row
    return [[ET.fromstring(cell.split("</td>")[0])
             for cell in row.split("<td>")[1:]] for row in rows]


def test_pos_page_predictions_match_jax(job, tmp_path):
    outputs, timings = {}, {}
    out = demo.run_demo(job["dir"], "pos", N, out_path=str(tmp_path / "p.html"),
                        device="cpu", outputs=outputs, timings=timings)
    assert set(timings) == {"load_model", "load_batch", "forward_eval",
                            "unbatch", "svg_html"}
    spec, schema = job["spec"], job["spec"].schema
    batch = to_jax(job["batch"])
    for k, v in job["batch"].items():
        np.testing.assert_array_equal(outputs["batch"][k], v, err_msg=k)
    masks = jax_demo.build_task_masks(schema, batch, "pos")
    tasks = None
    if job["jax_model"].context == "id":
        from flexdm_tpu.evaluation.harness import task_id_for_mode

        tasks = jnp.full((N,), task_id_for_mode(schema, "pos"), jnp.int32)
    want = jax_forward_eval(job["jax_model"], job["params"], batch, masks,
                            tasks=tasks)
    view = jax_demo.masked_input_view(schema, batch, masks)
    for k in want:
        np.testing.assert_allclose(outputs["pred"][k], np.asarray(want[k]),
                                   err_msg=k, **TOL)
    for k in view:
        np.testing.assert_array_equal(outputs["view"][k], np.asarray(view[k]),
                                      err_msg=k)
    # The page: N rows of ground truth, masked input and prediction.
    cells = _page_cells(out)
    assert len(cells) == N and all(len(row) == 3 for row in cells)
    builder = svg.SVGBuilder(
        key="type", vocab=spec.vocabs["type"].tokens, max_width=180,
        max_height=180, render_text=True)
    want_items = spec.unbatch({k: np.asarray(v) for k, v in want.items()})
    for row, item in zip(cells, want_items):
        assert len(row[2]) == len(ET.fromstring(builder(item)))


def test_run_demo_elem_maskgit_and_pinned_element(job, tmp_path):
    """``elem`` with MaskGIT (``num_iter=2``) and a pinned element: only
    the masked element's fields change; ``element`` with another task is a
    ValueError."""
    schema = job["spec"].schema
    out = {}
    demo.run_demo(job["dir"], "elem", N, num_iter=2, device="cpu",
                  out_path=str(tmp_path / "e.html"), outputs=out)
    assert len(_page_cells(tmp_path / "e.html")) == N
    pinned = {}
    demo.run_demo(job["dir"], "elem", N, element=0, device="cpu",
                  out_path=str(tmp_path / "e0.html"), outputs=pinned)
    for pred in (out["pred"], pinned["pred"]):
        for c in schema.modeled:
            if c.is_sequence and not c.is_categorical:
                changed = (pred[c.name] != pinned["batch"][c.name]).any(-1)
                assert changed.sum(-1).max() <= 1, c.name
    for c in schema.modeled:
        if c.is_sequence and not c.is_categorical:
            changed = (pinned["pred"][c.name]
                       != pinned["batch"][c.name]).any(-1)
            assert not changed[:, 1:].any(), c.name
            masked = pinned["view"][c.name][:, 0] != pinned["batch"][c.name][:, 0]
            assert masked.all(), c.name
    with pytest.raises(ValueError, match="only valid for task='elem'"):
        demo.run_demo(job["dir"], "pos", N, element=0, device="cpu",
                      out_path=str(tmp_path / "x.html"))


def test_main_on_the_cpu(job, tmp_path, capsys):
    out = str(tmp_path / "m.html")
    path = demo.main(["--job-dir", job["dir"], "--task", "pos",
                      "--num-examples", "2", "--out", out, "--device", "cpu",
                      "--data_dir", job["spec"].path])
    assert path == out and f"wrote {out}" in capsys.readouterr().out
    cells = _page_cells(out)
    assert len(cells) == 2 and all(len(row) == 3 for row in cells)


_NO_JAX = r"""
import importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "flexdm_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")

sys.meta_path.insert(0, Block())
import runpy
sys.argv = ["flexdm_tpu_torch.demo"] + sys.argv[1:]
runpy.run_module("flexdm_tpu_torch.demo", run_name="__main__")
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
"""


def test_demo_module_runs_with_jax_blocked(job, tmp_path):
    """``python -m flexdm_tpu_torch.demo`` with JAX and the JAX package
    unimportable."""
    out = str(tmp_path / "b.html")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "--job-dir", job["dir"],
         "--num-examples", "2", "--out", out, "--device", "cpu"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=120,
        env=dict(os.environ, FLEXDM_PLATFORM="cpu", PYTHONPATH=REPO),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"wrote {out}" in proc.stdout
    assert len(_page_cells(out)) == 2
