"""Run a notebook's code cells without Jupyter.

    python -m flexdm_tpu_torch.utils.notebook notebooks/demo_crello_torch.ipynb
        [--out page.html]

The card's machine has neither Jupyter nor IPython.  :func:`run_notebook`
executes the code cells in order in one namespace, as a kernel does, with
stand-ins for ``IPython.display``'s ``display`` and ``HTML`` that collect
what the cells display (in place of the real module for the run, so the
outputs are collected wherever IPython is installed), and a cell's last
expression collected as text, as Jupyter shows it.  The runner picks no
device and hides no error: a cell that raises ends the run with its
traceback.  The CLI prints one JSON line (the notebook, its HTML and text
outputs, seconds) and with ``--out`` writes the HTML outputs to one page.
"""

from __future__ import annotations

import argparse
import ast
import json
import sys
import time
import types
from typing import Dict, List


class HTML:
    """Stand-in for ``IPython.display.HTML``."""

    def __init__(self, data: str = ""):
        self.data = data

    def _repr_html_(self) -> str:
        return self.data


def _display_modules(outputs: List[Dict], cell: List[int]):
    """``IPython`` and ``IPython.display`` stand-ins whose ``display``
    appends ``{"cell": i, "text/html" or "text/plain": ...}`` to
    ``outputs`` (``cell[0]`` is the running cell's index)."""

    def display(*objs, **_):
        for obj in objs:
            html = getattr(obj, "_repr_html_", None)
            outputs.append({"cell": cell[0], "text/html": html()}
                           if html is not None else
                           {"cell": cell[0], "text/plain": repr(obj)})

    mod = types.ModuleType("IPython.display")
    mod.HTML, mod.display = HTML, display
    package = types.ModuleType("IPython")
    package.display = mod
    return {"IPython": package, "IPython.display": mod}, display


def run_notebook(path: str) -> List[Dict]:
    """Execute the code cells of the notebook at ``path``; returns the
    outputs in order, each ``{"cell": index, "text/html": ...}`` or
    ``{"cell": index, "text/plain": ...}``."""
    with open(path) as f:
        cells = json.load(f)["cells"]
    outputs: List[Dict] = []
    cell = [0]
    stand_ins, display = _display_modules(outputs, cell)
    saved = {name: sys.modules.get(name) for name in stand_ins}
    sys.modules.update(stand_ins)
    namespace = {"__name__": "__main__"}
    try:
        for index, nb_cell in enumerate(cells):
            if nb_cell["cell_type"] != "code":
                continue
            cell[0] = index
            name = f"{path}, cell {index}"
            tree = ast.parse("".join(nb_cell["source"]), name)
            last = None
            if tree.body and isinstance(tree.body[-1], ast.Expr):
                last = ast.Expression(tree.body.pop().value)
            exec(compile(tree, name, "exec"), namespace)
            if last is not None:
                value = eval(compile(last, name, "eval"), namespace)
                if value is not None:
                    display(value)
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module
    return outputs


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("notebook")
    parser.add_argument("--out", default=None,
                        help="write the HTML outputs to this page")
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    outputs = run_notebook(args.notebook)
    html = [o["text/html"] for o in outputs if "text/html" in o]
    if args.out:
        with open(args.out, "w") as f:
            f.write("<html><head><meta charset='utf-8'></head><body>"
                    + "\n".join(html) + "</body></html>")
    summary = {"notebook": args.notebook, "html_outputs": len(html),
               "text_outputs": [o["text/plain"] for o in outputs
                                if "text/plain" in o],
               "seconds": time.perf_counter() - t0}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
