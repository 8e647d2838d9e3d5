"""Generate docs/API.md — the rendered API reference.

The reference ships generated per-class XML docs (doc_classes/*.xml,
rendered by Godot's doc pipeline); this framework's equivalent is a
single rendered markdown reference extracted from the live package:
every public module, class, dataclass field block, and function
signature with the first paragraph of its docstring.

Run: python tools/gen_api_docs.py   (rewrites docs/API.md)
CI check: --check exits nonzero if docs/API.md is stale.
"""

import argparse
import importlib
import inspect
import os
import pkgutil
import sys

sys.path.insert(0, ".")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

PACKAGE = "messyerraytracer"
OUT = os.path.join("docs", "API.md")

SKIP_MODULES = {"conftest"}


def first_paragraph(doc: str | None) -> str:
    if not doc:
        return ""
    lines = []
    for ln in inspect.cleandoc(doc).splitlines():
        if not ln.strip() and lines:
            break
        if ln.strip():
            lines.append(ln.strip())
    return " ".join(lines)


def fmt_signature(obj) -> str:
    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    return sig if len(sig) <= 100 else "(...)"


def public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        home = getattr(obj, "__module__", None)
        if home is not None and not str(home).startswith(PACKAGE):
            continue
        if inspect.isclass(obj) or inspect.isfunction(obj):
            out.append((n, obj))
    return out


def render_class(name, cls, lines):
    lines.append(f"#### class `{name}`\n")
    p = first_paragraph(cls.__doc__)
    if p:
        lines.append(p + "\n")
    # dataclass-style field listing (the SoA pytree containers)
    ann = getattr(cls, "__annotations__", {})
    if ann:
        lines.append("Fields: " + ", ".join(f"`{f}`" for f in ann) + "\n")
    for mname, m in sorted(vars(cls).items()):
        if mname.startswith("_") or not callable(m):
            continue
        doc = first_paragraph(getattr(m, "__doc__", ""))
        lines.append(f"- `{mname}{fmt_signature(m)}`"
                     + (f" — {doc}" if doc else ""))
    lines.append("")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if docs/API.md is stale")
    args = ap.parse_args()

    pkg = importlib.import_module(PACKAGE)
    lines = [
        "# messyerraytracer — API reference",
        "",
        "Generated by `python tools/gen_api_docs.py` — do not edit by "
        "hand.  The reference project ships generated per-class docs "
        "(doc_classes/*.xml); this file is this framework's rendered "
        "equivalent, extracted from the live package docstrings.",
        "",
    ]

    # top-level exports first (the api firewall surface)
    lines.append("## Top-level exports (`import messyerraytracer`)\n")
    for n, obj in public_members(pkg):
        kind = "class" if inspect.isclass(obj) else "def"
        doc = first_paragraph(obj.__doc__)
        sig = "" if inspect.isclass(obj) else fmt_signature(obj)
        lines.append(f"- **`{n}{sig}`** ({kind})"
                     + (f" — {doc}" if doc else ""))
    lines.append("")

    mods = []
    for m in pkgutil.walk_packages(pkg.__path__, prefix=PACKAGE + "."):
        short = m.name.split(".")[-1]
        if short.startswith("_") or short in SKIP_MODULES:
            continue
        if short.startswith("test_"):
            continue
        mods.append(m.name)

    for mname in sorted(mods):
        try:
            mod = importlib.import_module(mname)
        except Exception as e:  # optional deps / native fallbacks
            lines.append(f"## `{mname}`\n\n(unimportable here: {e})\n")
            continue
        members = [
            (n, o) for n, o in public_members(mod)
            if getattr(o, "__module__", mname) == mname
        ]
        if not members:
            continue
        lines.append(f"## `{mname}`\n")
        p = first_paragraph(mod.__doc__)
        if p:
            lines.append(p + "\n")
        for n, obj in members:
            if inspect.isclass(obj):
                render_class(n, obj, lines)
            else:
                doc = first_paragraph(obj.__doc__)
                lines.append(f"#### `{n}{fmt_signature(obj)}`\n")
                if doc:
                    lines.append(doc + "\n")
        lines.append("")

    text = "\n".join(lines).rstrip() + "\n"
    if args.check:
        try:
            old = open(OUT).read()
        except FileNotFoundError:
            old = ""
        if old != text:
            print("docs/API.md is stale — run python tools/gen_api_docs.py")
            sys.exit(1)
        print("docs/API.md up to date")
        return
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        f.write(text)
    print(f"wrote {OUT}: {len(text.splitlines())} lines")


if __name__ == "__main__":
    main()
