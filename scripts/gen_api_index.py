#!/usr/bin/env python
"""Generate docs/API.md: one line per public symbol (first docstring
sentence), grouped by module.  Run on CPU:
    python scripts/gen_api_index.py
"""
import inspect
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import fft_wgpu_tpu as ftt
import fft_wgpu_tpu.models as models
from fft_wgpu_tpu.parallel import mesh, multihost, pencil


def first_line(obj) -> str:
    doc = inspect.getdoc(obj) or ""
    line = doc.split("\n")[0].strip()
    return line.rstrip(".")


def rows(namespace, names):
    out = []
    for n in sorted(names):
        obj = getattr(namespace, n, None)
        if obj is None:
            continue
        out.append(f"| `{n}` | {first_line(obj)} |")
    return out


def section(title, namespace, names):
    body = "\n".join(rows(namespace, names))
    return f"## {title}\n\n| symbol | summary |\n|---|---|\n{body}\n"


def public(mod):
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n in dir(mod) if not n.startswith("_")
            and callable(getattr(mod, n))]


def main():
    top = [n for n in ftt.__all__ if n != "__version__"]
    parts = [
        "# fft_wgpu_tpu — public API index\n",
        "Generated by scripts/gen_api_index.py — do not edit by hand.\n",
        section("fft_wgpu_tpu (top level)", ftt, top),
        section("fft_wgpu_tpu.models", models, public(models)),
        section("fft_wgpu_tpu.parallel.pencil", pencil, public(pencil)),
        section("fft_wgpu_tpu.parallel.mesh", mesh, public(mesh)),
        section("fft_wgpu_tpu.parallel.multihost", multihost,
                public(multihost)),
    ]
    path = os.path.join(os.path.dirname(__file__), "..", "docs", "API.md")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(parts))
    print(f"wrote {os.path.normpath(path)}: {len(open(path).readlines())} "
          "lines")


if __name__ == "__main__":
    main()
