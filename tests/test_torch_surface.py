"""The port's public surface is the JAX package's.

Every public call of ``spectavi_tpu`` runs unchanged in
``spectavi_tpu_torch`` under one rule:

* a JAX parameter ``key`` (a PRNG key) becomes ``generator`` (a
  ``torch.Generator``, or None for the seeded default), at the same
  position;
* parameters that the port adds (``sample``, ``planes``, ``perm``,
  ``perms``, ``init``, ``device``, ``images``, ...) come after all of
  JAX's, or are keyword-only;
* so a JAX positional call binds the same values in the port, and the
  defaults are JAX's.

The checks read both packages' sources with ``ast`` (nothing of JAX is
imported), one parametrised case per item:

* (a) exports: every name that a JAX package ``__init__`` imports or
  defines exists in the port's; the subpackages resolve as attributes
  after a fresh ``import spectavi_tpu_torch``, in a process that then
  holds neither ``jax`` nor an initialized CUDA;
* (b) each JAX module's twin: every public name it defines exists there,
  and every public function (and class constructor) takes JAX's
  positional parameters, ``key`` read as ``generator``, as a prefix of
  its own, with JAX's defaults;
* (c) the allow-list below: each entry names something that exists in
  the JAX package and that the port still lacks (a name, a parameter)
  or still takes with another default, so the list cannot go stale.
"""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "spectavi_tpu"
PORT_PKG = ROOT / "spectavi_tpu_torch"

# Deliberate differences: (JAX file, top-level name, parameter or None) -> reason.
PALLAS = "a Pallas TPU entry point or its tiling constant; the CUDA kernel under csrc/ replaces it"
ALLOWED = {
    ("parallel/mesh.py", "make_mesh", "devices"):
        "one process per GPU, so a rank has one device: device_type and backend take its place",
    ("ops/l2nn_pallas.py", "l2_topk2_pallas", None): PALLAS,
    ("ops/l2nn_pallas.py", "l2_topk2_fused", None): PALLAS,
    ("ops/sift_orient.py", "sift_orient_hist_pallas", None): PALLAS,
    ("ops/sift_orient.py", "PATCH_R", None): PALLAS,
    ("ops/sift_orient.py", "PATCH_C", None): PALLAS,
    ("ops/sift_orient.py", "KB", None): PALLAS,
    ("ops/sift_orient.py", "CHUNK", None): PALLAS,
    ("ops/sift_desc.py", "sift_descriptors_pallas", None): PALLAS,
    ("ops/sift_desc.py", "PATCH_R", None): PALLAS,
    ("ops/sift_desc.py", "PATCH_C", None): PALLAS,
    ("ops/sift_desc.py", "OUT_LANES", None): PALLAS,
    ("ops/sift_desc.py", "KB", None): PALLAS,
    ("ops/sift_desc.py", "CHUNK", None): PALLAS,
    ("__init__.py", "_cache_dir", None): "the XLA persistent compile cache; the port compiles no XLA",
    ("utils/profiling.py", "trace", "logdir"):
        "JAX's default is a fixed /tmp path, which ignores TMPDIR and lets two checkouts' runs "
        "write into one directory; the port's None means a directory under tempfile.gettempdir()",
}
ALLOWED_NAMES = {(f, n) for f, n, p in ALLOWED if p is None}
ALLOWED_PARAMS = {(f, n, p) for f, n, p in ALLOWED if p is not None}

JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py"))
JAX_INITS = [m for m in JAX_MODULES if m.endswith("__init__.py")]


def _tree(path):
    return ast.parse(path.read_text(), str(path))


def _bound_names(path):
    """Top-level names a module binds by ``def``, ``class``, assignment
    or ``from ... import`` (not ``import x as y``)."""
    names = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                names.update(e.id for e in ast.walk(t) if isinstance(e, ast.Name))
        elif isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return names


def _defined_names(path):
    """Public top-level names a module itself defines (not imports)."""
    names = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                names.update(e.id for e in ast.walk(t) if isinstance(e, ast.Name))
    return {n for n in names if not n.startswith("_")}


def _signature(node):
    """``(positional names, keyword-only names, defaults by name)`` of a
    function, or of a class's ``__init__`` without ``self``."""
    if isinstance(node, ast.ClassDef):
        init = next((b for b in node.body
                     if isinstance(b, ast.FunctionDef) and b.name == "__init__"), None)
        if init is None:
            return [], [], {}
        pos, kw, defaults = _signature(init)
        return pos[1:], kw, defaults
    a = node.args
    pos = [x.arg for x in a.posonlyargs + a.args]
    defaults = dict(zip(pos[len(pos) - len(a.defaults):], a.defaults))
    defaults.update((x.arg, d) for x, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None)
    return pos, [x.arg for x in a.kwonlyargs], {k: _default_text(v) for k, v in defaults.items()}


def _default_text(node):
    # a dtype default is the same default in either package: jnp.float64
    # and torch.float64 compare equal
    return re.sub(r"\b(jnp|np|numpy|torch)\.", "", ast.unparse(node))


def _public_defs(path):
    return {n.name: n for n in _tree(path).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


def _port_def(rel, name):
    """The port's definition of ``name`` in the twin of ``rel``,
    following one ``from spectavi_tpu_torch... import`` hop."""
    path = PORT_PKG / rel
    tree = _tree(path)
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.name == name:
            return node
    for node in tree.body:
        if (isinstance(node, ast.ImportFrom) and node.module
                and node.module.startswith("spectavi_tpu_torch")
                and any((a.asname or a.name) == name for a in node.names)):
            src = ROOT / (node.module.replace(".", "/") + ".py")
            if not src.exists():
                src = ROOT / node.module.replace(".", "/") / "__init__.py"
            return _port_def(src.relative_to(PORT_PKG).as_posix(), name)
    return None


def _module_name(rel):
    parts = rel[: -len(".py")].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["spectavi_tpu_torch"] + parts)


@pytest.mark.parametrize("rel", JAX_INITS)
def test_exports(rel):
    import importlib

    names = _bound_names(JAX_PKG / rel)
    wanted = sorted(n for n in names if (rel, n) not in ALLOWED_NAMES)
    if rel == "__init__.py":
        # the subpackages, after a fresh import, in a process of its own
        code = (
            "import sys, torch\n"
            "import spectavi_tpu_torch as p\n"
            f"missing = [n for n in {wanted!r} if not hasattr(p, n)]\n"
            "assert not missing, missing\n"
            "assert 'mvg' in dir(p)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'spectavi_tpu')]\n"
            "assert not bad, bad\n"
            "assert not torch.cuda.is_initialized()\n"
        )
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        assert {"mvg", "features", "match", "pipeline", "sfm"} <= set(wanted)
        return
    module = importlib.import_module(_module_name(rel))
    missing = [n for n in wanted if not hasattr(module, n)]
    assert not missing, f"{_module_name(rel)} lacks {missing}"


@pytest.mark.parametrize("rel", [m for m in JAX_MODULES if m not in JAX_INITS])
def test_module_surface(rel):
    names = {n for n in _defined_names(JAX_PKG / rel) if (rel, n) not in ALLOWED_NAMES}
    if not names:
        return
    port = PORT_PKG / rel
    assert port.exists(), f"spectavi_tpu/{rel} has no twin in the port"
    missing = sorted(names - _bound_names(port))
    assert not missing, f"spectavi_tpu_torch/{rel} lacks {missing}"
    faults = []
    for name, node in sorted(_public_defs(JAX_PKG / rel).items()):
        if (rel, name) in ALLOWED_NAMES:
            continue
        twin = _port_def(rel, name)
        jpos, jkw, jdef = _signature(node)
        tpos, tkw, tdef = _signature(twin)
        # an allowed parameter the port lacks drops out; one it takes
        # keeps its position but may have another default
        allowed = {p for f, n, p in ALLOWED_PARAMS if (f, n) == (rel, name)}
        jpos = ["generator" if p == "key" else p for p in jpos
                if p not in allowed or p in tpos + tkw]
        jdef = {("generator" if k == "key" else k): v for k, v in jdef.items()
                if k not in allowed}
        if tpos[: len(jpos)] != jpos:
            faults.append(f"{name}: JAX's positional {jpos}, the port's {tpos}")
        if not set(jkw) <= set(tpos) | set(tkw):
            faults.append(f"{name}: keyword-only {jkw} missing")
        for p, d in jdef.items():
            if p in jpos + jkw and tdef.get(p) != d:
                faults.append(f"{name}: default of {p} is {tdef.get(p)}, JAX's {d}")
    assert not faults, f"spectavi_tpu_torch/{rel}: " + "; ".join(faults)


@pytest.mark.parametrize("entry", sorted(ALLOWED, key=str), ids=lambda e: "::".join(
    x for x in e if x))
def test_allow_list_is_current(entry):
    rel, name, param = entry
    assert ALLOWED[entry]
    path = JAX_PKG / rel
    assert path.exists(), f"spectavi_tpu/{rel} is gone"
    assert name in _bound_names(path), f"spectavi_tpu/{rel} no longer has {name}"
    port = PORT_PKG / rel
    if param is None:
        # still a difference: the port does not have the name
        assert not (port.exists() and name in _bound_names(port)), (
            f"the port now has {rel}::{name}; drop it from the list")
        return
    jpos, _, jdef = _signature(_public_defs(path)[name])
    assert param in jpos
    pos, kw, tdef = _signature(_port_def(rel, name))
    # still a difference: the port lacks the parameter, or its default differs
    assert param not in pos + kw or tdef.get(param) != jdef.get(param), (
        f"the port's {name} now takes {param} as JAX does; drop it from the list")
