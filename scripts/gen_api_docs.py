#!/usr/bin/env python
"""Generate the msm_we_tpu API reference (markdown) from live docstrings.

The reference ships a Sphinx site whose ``docs/api.rst`` autosummarizes the
public surface (``/root/reference/docs/api.rst``); this environment has no
sphinx/pdoc, so this is a self-contained stdlib generator producing the same
inventory as browsable markdown under ``docs/api/``. Deterministic output
(sorted members, no timestamps) so the generated tree is committed and a test
asserts freshness (``tests/test_api_docs.py``).

Usage::

    python scripts/gen_api_docs.py [output_dir]   # default: docs/api
"""
from __future__ import annotations

import importlib
import inspect
import sys
from pathlib import Path

# The documented surface, mirroring the reference's api.rst sections
# (msm_we.modelWE, msm_we.optimization, msm_we.fpt/ensembles/nmm/utils,
# msm_we.westpa_plugins.*) plus the device layers the reference has no
# counterpart for (ops/, parallel/, data/).
SECTIONS = [
    (
        "haMSM model building and analysis",
        [
            "msm_we_tpu.model",
            "msm_we_tpu.features",
            "msm_we_tpu.discretization",
            "msm_we_tpu.fluxmatrix",
            "msm_we_tpu.cleaning",
            "msm_we_tpu.bootstrap",
            "msm_we_tpu.structures",
            "msm_we_tpu.binning",
            "msm_we_tpu.plotting",
        ],
    ),
    (
        "WE optimization",
        ["msm_we_tpu.optimization"],
    ),
    (
        "WESTPA plugins",
        [
            "msm_we_tpu.westpa_plugins.augmentation_driver",
            "msm_we_tpu.westpa_plugins.hamsm_driver",
            "msm_we_tpu.westpa_plugins.restart_driver",
            "msm_we_tpu.westpa_plugins.optimization_driver",
        ],
    ),
    (
        "FPT calculations and Markov models",
        [
            "msm_we_tpu.msm.fpt",
            "msm_we_tpu.msm.ensembles",
            "msm_we_tpu.msm.nmm",
            "msm_we_tpu.utils",
        ],
    ),
    (
        "Data ingest",
        [
            "msm_we_tpu.data.westh5",
            "msm_we_tpu.data.synthetic",
        ],
    ),
    (
        "Device compute kernels (no reference counterpart)",
        [
            "msm_we_tpu.ops.pca",
            "msm_we_tpu.ops.kmeans",
            "msm_we_tpu.ops.stratified",
            "msm_we_tpu.ops.linalg",
        ],
    ),
    (
        "Multi-chip / multi-host parallelism (no reference counterpart)",
        [
            "msm_we_tpu.parallel.mesh",
            "msm_we_tpu.parallel.sharded",
            "msm_we_tpu.parallel.distributed",
        ],
    ),
    (
        "Infrastructure",
        [
            "msm_we_tpu.cli",
            "msm_we_tpu.tracing",
            "msm_we_tpu.extended",
            "msm_we_tpu.testing",
        ],
    ),
]


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj):
    doc = inspect.getdoc(obj)
    return doc.rstrip() if doc else "*(undocumented)*"


def _public_members(mod):
    """Public functions/classes defined in (not imported into) ``mod``."""
    names = getattr(mod, "__all__", None)
    out = []
    for name, obj in sorted(vars(mod).items()):
        if name.startswith("_"):
            continue
        if not (inspect.isfunction(obj) or inspect.isclass(obj)):
            continue
        if names is not None:
            if name not in names:
                continue
        elif getattr(obj, "__module__", None) != mod.__name__:
            continue
        out.append((name, obj))
    return out


def _class_methods(cls):
    out = []
    for name, obj in sorted(vars(cls).items()):
        if name.startswith("_"):
            continue
        if isinstance(obj, property):
            out.append((name, obj, "property"))
        elif isinstance(obj, staticmethod):
            out.append((name, obj.__func__, "staticmethod"))
        elif isinstance(obj, classmethod):
            out.append((name, obj.__func__, "classmethod"))
        elif inspect.isfunction(obj):
            out.append((name, obj, "method"))
    return out


def _render_module(mod_name):
    mod = importlib.import_module(mod_name)
    lines = [f"# `{mod_name}`", ""]
    lines += [_doc(mod), ""]
    members = _public_members(mod)
    for name, obj in members:
        if inspect.isclass(obj):
            lines += [f"## class `{name}{_sig(obj)}`", "", _doc(obj), ""]
            for mname, mobj, kind in _class_methods(obj):
                if kind == "property":
                    lines += [f"### property `{name}.{mname}`", ""]
                    lines += [_doc(mobj), ""]
                else:
                    tag = "" if kind == "method" else f" *({kind})*"
                    lines += [
                        f"### `{name}.{mname}{_sig(mobj)}`{tag}",
                        "",
                        _doc(mobj),
                        "",
                    ]
        else:
            lines += [f"## `{name}{_sig(obj)}`", "", _doc(obj), ""]
    return "\n".join(lines).rstrip() + "\n"


def generate(out_dir):
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    index = [
        "# msm_we_tpu API reference",
        "",
        "Generated from docstrings by `scripts/gen_api_docs.py` "
        "(the sphinx-free equivalent of the reference's `docs/api.rst`). "
        "Regenerate with `python scripts/gen_api_docs.py` after changing "
        "public signatures or docstrings.",
        "",
    ]
    written = []
    for title, mod_names in SECTIONS:
        index += [f"## {title}", ""]
        for mod_name in mod_names:
            fname = mod_name.replace(".", "_") + ".md"
            (out_dir / fname).write_text(_render_module(mod_name))
            written.append(fname)
            mod = importlib.import_module(mod_name)
            first = (_doc(mod).splitlines() or [""])[0]
            index += [f"- [`{mod_name}`]({fname}) — {first}"]
        index += [""]
    (out_dir / "index.md").write_text("\n".join(index).rstrip() + "\n")
    written.append("index.md")
    return written


if __name__ == "__main__":
    target = sys.argv[1] if len(sys.argv) > 1 else (
        Path(__file__).resolve().parent.parent / "docs" / "api"
    )
    files = generate(target)
    print(f"wrote {len(files)} files to {target}")
