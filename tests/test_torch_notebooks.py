"""The port's demo notebooks (``notebooks/demo_{crello,rico}_torch.ipynb``):
the committed files are ``tools/torch_build_notebooks.py``'s output and
valid nbformat 4; their cells import only the port; each runs on the CPU
through the port's runner (``flexdm_tpu_torch/utils/notebook.py``) with
JAX blocked, bootstrapping a toy job and rendering its grids as HTML."""

import json
import os
import subprocess
import sys

import nbformat
import pytest

from flexdm_tpu_torch.utils import notebook
from tests.test_torch_tools import _BLOCKED, ROOT, TIMEOUT_S
from tools import torch_build_notebooks

RUNNER = os.path.join(ROOT, "flexdm_tpu_torch", "utils", "notebook.py")
ENV = {"demo_crello_torch.ipynb": ("FLEXDM_JOB_DIR", "FLEXDM_DATA_DIR"),
       "demo_rico_torch.ipynb": ("FLEXDM_RICO_JOB_DIR",
                                 "FLEXDM_RICO_DATA_DIR")}
NAMES = sorted(torch_build_notebooks.NOTEBOOKS)


def _path(name):
    return os.path.join(ROOT, "notebooks", name)


@pytest.mark.parametrize("name", NAMES)
def test_committed_notebook_is_the_builders(name):
    with open(_path(name), encoding="utf-8") as f:
        text = f.read()
    assert text == torch_build_notebooks._nb(
        name, torch_build_notebooks.NOTEBOOKS[name])
    nb = nbformat.reads(text, as_version=4)
    nbformat.validate(nb)
    code = "".join(c.source for c in nb.cells if c.cell_type == "code")
    assert "flexdm_tpu_torch" in code
    for banned in ("import jax", "from jax", "flax", "flexdm_tpu.",
                   "from flexdm_tpu import", "import flexdm_tpu\n"):
        assert banned not in code, banned


@pytest.mark.parametrize("name", NAMES)
def test_notebook_runs_on_the_cpu_with_jax_blocked(name, tmp_path):
    job_var, data_var = ENV[name]
    env = dict(os.environ, FLEXDM_DEVICE="cpu", **{
        job_var: str(tmp_path / "job"), data_var: str(tmp_path / "data")})
    page = tmp_path / "page.html"
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED, RUNNER, _path(name), "--out",
         str(page)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["html_outputs"] >= 2
    assert page.read_text().count("<svg") >= 2 * 4
    assert (tmp_path / "job" / "checkpoints" / "best.torch.npz").exists()
    if name == "demo_rico_torch.ipynb":  # the evaluate_task cell's scores
        (scores,) = summary["text_outputs"]
        assert set(eval(scores)) == {"left", "top", "width", "height"}


def test_notebook_without_a_card_refuses_cuda(tmp_path, monkeypatch):
    monkeypatch.delenv("FLEXDM_DEVICE", raising=False)
    monkeypatch.setenv("FLEXDM_JOB_DIR", str(tmp_path / "job"))
    monkeypatch.setenv("FLEXDM_DATA_DIR", str(tmp_path / "data"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        notebook.run_notebook(_path("demo_crello_torch.ipynb"))
    assert not (tmp_path / "job").exists()


def test_runner_collects_outputs_and_restores_ipython(tmp_path):
    cells = [("md", "# t"),
             ("code", "from IPython.display import HTML, display\n"
                      "display(HTML('<b>x</b>'), 3)\nx = 2"),
             ("code", "x + 1"), ("code", "y = None\ny")]
    path = tmp_path / "t.ipynb"
    path.write_text(torch_build_notebooks._nb("t", cells))
    before = sys.modules.get("IPython.display")
    assert notebook.run_notebook(str(path)) == [
        {"cell": 1, "text/html": "<b>x</b>"}, {"cell": 1, "text/plain": "3"},
        {"cell": 2, "text/plain": "3"}]
    assert sys.modules.get("IPython.display") is before
    path.write_text(torch_build_notebooks._nb("t", [("code", "1 / 0")]))
    with pytest.raises(ZeroDivisionError):
        notebook.run_notebook(str(path))
    assert sys.modules.get("IPython.display") is before
