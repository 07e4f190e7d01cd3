"""The port's API reference and user pages (the counterpart of
tests/test_docs.py).

* ``docs/gen_api_torch.py`` writes a page for every module of
  ``svgdcpp_tpu_torch``, found here by listing the package's files, not by
  the generator's own walk; the ``svgd`` page names ``SVGDOptions``,
  ``build_step_fn`` and ``make_state``.
* Run in a subprocess, the generator leaves neither ``jax`` nor
  ``svgdcpp_tpu`` in ``sys.modules``.
* The committed ``docs/api_torch/`` is what a fresh run writes.
* Every repo path written in backticks in ``docs/torch_instructions.md``
  and ``docs/torch_parity.md`` exists (a file with an extension, or a path
  with a slash, with any ``:line`` suffix dropped).
"""

import re
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "svgdcpp_tpu_torch"
PAGES = ("docs/torch_instructions.md", "docs/torch_parity.md")


def _package_modules():
    """Module names of every public .py file and package under the port."""
    names = set()
    for path in PACKAGE.rglob("*.py"):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if all(not p.startswith("_") for p in parts):
            names.add(".".join(parts))
    return names


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    out = tmp_path_factory.mktemp("api_torch")
    runpy.run_path(str(ROOT / "docs" / "gen_api_torch.py"))["main"](out)
    return out


def test_a_page_for_every_module(generated):
    modules = _package_modules()
    assert {f"svgdcpp_tpu_torch.{name}" for name in (
        "entry", "ops.cuda_phi", "ops.sym_plan", "utils.convert",
        "utils.cuda_build", "parallel.dryrun")} <= modules
    pages = {p.name for p in generated.glob("*.md")}
    want = {m.replace(".", "_") + ".md" for m in modules} | {"index.md"}
    assert pages == want
    index = (generated / "index.md").read_text()
    for modname in modules:
        assert f"[`{modname}`]" in index, modname
    for sym in ("SVGD", "GaussianRBFKernel", "TorchOptimizer", "st.entry"):
        assert sym in index, sym


def test_the_svgd_page_names_the_step_surface(generated):
    driver = (generated / "svgdcpp_tpu_torch_svgd.md").read_text()
    for sym in ("SVGDOptions", "class `SVGD", "build_step_fn", "make_state"):
        assert sym in driver, sym
    entry = (generated / "svgdcpp_tpu_torch_entry.md").read_text()
    assert "### `entry(device='cuda', dtype=torch.float32)`" in entry


def test_the_generator_imports_neither_jax_nor_the_jax_package(tmp_path):
    probe = (
        "import runpy, sys; "
        "runpy.run_path(sys.argv[1])['main'](sys.argv[2]); "
        "print(sorted(m for m in ('jax', 'svgdcpp_tpu') if m in sys.modules))"
    )
    out = subprocess.run(
        [sys.executable, "-c", probe, str(ROOT / "docs" / "gen_api_torch.py"),
         str(tmp_path)],
        capture_output=True, text=True, check=True, cwd=tmp_path)
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert (tmp_path / "index.md").exists()


def test_the_committed_pages_are_a_fresh_run(generated):
    committed = ROOT / "docs" / "api_torch"
    assert ({p.name for p in committed.glob("*.md")}
            == {p.name for p in generated.glob("*.md")})
    stale = [p.name for p in generated.glob("*.md")
             if p.read_text() != (committed / p.name).read_text()]
    assert not stale, (f"docs/api_torch is stale ({stale}): run "
                       "python docs/gen_api_torch.py")


#: A backticked repo path: a file with one of the repo's extensions or a
#: path with a slash, optionally followed by :line or :line-line.
REPO_PATH = re.compile(
    r"`((?:[\w.-]+/)*[\w.-]+\.(?:py|md|cu|cuh|ipynb|json|cpp|toml)"
    r"|(?:[\w.-]+/)+[\w.-]*)(?::\d+(?:-\d+)?)?`")


@pytest.mark.parametrize("page", PAGES)
def test_every_cited_repo_path_exists(page):
    text = (ROOT / page).read_text()
    cited = {m.group(1) for m in REPO_PATH.finditer(text)}
    assert len(cited) >= 10, f"{page} cites almost no repo path: {cited}"
    missing = sorted(p for p in cited if not (ROOT / p).exists())
    assert not missing, f"{page} cites paths that do not exist: {missing}"
