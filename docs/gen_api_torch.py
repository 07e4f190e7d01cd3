"""Generated API reference of svgdcpp_tpu_torch (the PyTorch/CUDA port).

The port's counterpart of ``docs/gen_api.py``: one markdown page per module
of ``svgdcpp_tpu_torch`` plus an index, written to ``docs/api_torch/``.
The module list is found by walking the package, so every module is
documented, a new one included.

    python docs/gen_api_torch.py [outdir]

Run from the repo root (or anywhere: the repo root is put on sys.path). It
reuses ``gen_api.py``'s rendering helpers, which import nothing of
``svgdcpp_tpu``; this script imports neither ``jax`` nor ``svgdcpp_tpu``,
and importing the port builds no kernel.
"""

from __future__ import annotations

import importlib
import pkgutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "docs"))

from gen_api import _is_public, render_module  # noqa: E402

PACKAGE = "svgdcpp_tpu_torch"


def modules() -> list[str]:
    """The package and every module under it, in walk order (packages
    before their modules), skipping private names."""
    pkg = importlib.import_module(PACKAGE)
    found = [PACKAGE]
    for info in pkgutil.walk_packages(pkg.__path__, prefix=PACKAGE + "."):
        if all(_is_public(part) for part in info.name.split(".")):
            found.append(info.name)
    return found


def main(outdir=None) -> Path:
    out = Path(outdir) if outdir else ROOT / "docs" / "api_torch"
    out.mkdir(parents=True, exist_ok=True)
    pkg = importlib.import_module(PACKAGE)
    exports = sorted(n for n in pkg.__all__ if _is_public(n))
    names = modules()
    index = [
        "# svgdcpp_tpu_torch API reference",
        "",
        "The PyTorch/CUDA port of `svgdcpp_tpu` (`docs/api/` is the JAX",
        "package's reference). Generated by `python docs/gen_api_torch.py`",
        "(`make docs-torch`) from the modules found by walking the package.",
        "User pages: [docs/torch_instructions.md](../torch_instructions.md),",
        "[docs/torch_parity.md](../torch_parity.md).",
        "",
        "## Top-level exports (`import svgdcpp_tpu_torch as st`)",
        "",
        ", ".join(f"`{n}`" for n in exports),
        "",
        "Also `st.entry` (`svgdcpp_tpu_torch.entry.entry`), one pure SVGD",
        "step of the flagship, the counterpart of `__graft_entry__.entry`.",
        "",
        f"## Modules ({len(names)})",
        "",
    ]
    for modname in names:
        page = modname.replace(".", "_") + ".md"
        (out / page).write_text(render_module(modname))
        index.append(f"- [`{modname}`]({page})")
    index.append("")
    (out / "index.md").write_text("\n".join(index))
    print(f"wrote {len(names) + 1} pages to {out}")
    return out


if __name__ == "__main__":
    main(*sys.argv[1:])
