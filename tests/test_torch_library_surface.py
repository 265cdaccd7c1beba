"""The port's library surface against the JAX package's, read from both source trees (this
file imports neither package's modules for the comparison, and no JAX at all): every name
in the ``__all__`` of a JAX ``__init__`` imports from the port's counterpart package, and
every public function, class, method and module constant of ``denovo_kmer_tpu/<m>.py`` has
a counterpart of the same name in ``denovo_kmer_tpu_torch/<m>.py`` that accepts each of the
JAX parameters by name. ``ALLOWED`` holds the design differences; each names the ROADMAP.md
§3 item that records it."""

import ast
import importlib
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "denovo_kmer_tpu")
PORT_PKG = os.path.join(ROOT, "denovo_kmer_tpu_torch")

#: what the port leaves out on purpose: "module", "module:name", "module:name(param)" or
#: "module:Class.method(param)" of the JAX package → the title of its ROADMAP.md §3 item
ALLOWED = {
    "ops/extract_pallas.py": "the Pallas modules",
    "ops/partition_pallas.py": "the Pallas modules",
    "parallel/probe.py:probe_shard_alltoall(shard)": "the sharded probe's shard bodies",
    "parallel/probe.py:probe_shard_alltoall(axis)": "the sharded probe's shard bodies",
    "parallel/probe.py:probe_shard_ring(shard)": "the sharded probe's shard bodies",
    "parallel/probe.py:probe_shard_ring(axis)": "the sharded probe's shard bodies",
    "parallel/sharded_table.py:ShardedKmerEngine.ingest_global(words)":
        "the sharded engine's host methods",
    "parallel/sharded_table.py:ShardedKmerEngine.ingest_global(vwords)":
        "the sharded engine's host methods",
    "parallel/sharded_table.py:ShardedKmerEngine.ingest_score_global(words)":
        "the sharded engine's host methods",
    "parallel/sharded_table.py:ShardedKmerEngine.ingest_score_global(vwords)":
        "the sharded engine's host methods",
    "parallel/sharded_table.py:ShardedKmerEngine.*_dev": "the engine's jitted internals",
    "pipeline.py:SampleTableBuilder.__init__(steps)": "the builders' ingest step",
    "pipeline.py:ScoringTableBuilder.__init__(extract_append)": "the builders' ingest step",
}


def _modules(pkg):
    return sorted(os.path.relpath(os.path.join(d, f), pkg).replace(os.sep, "/")
                  for d, _, files in os.walk(pkg) for f in files if f.endswith(".py"))


JAX_MODULES = _modules(JAX_PKG)
JAX_INITS = [m for m in JAX_MODULES if m.endswith("__init__.py")]


def _tree(pkg, rel):
    with open(os.path.join(pkg, rel)) as f:
        return ast.parse(f.read(), rel)


def _params(fn):
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if n not in ("self", "cls")]


def _class_surface(node):
    """{"__init__": params, method: params, ...} of a class body: an explicit ``__init__``,
    else its annotated fields (a dataclass or NamedTuple); public methods, and public names
    bound in the body to another method (``alias = method``)."""
    methods = {b.name: _params(b) for b in node.body if isinstance(b, ast.FunctionDef)}
    out = {}
    if "__init__" in methods:
        out["__init__"] = methods["__init__"]
    else:
        out["__init__"] = [b.target.id for b in node.body
                           if isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name)]
    for b in node.body:
        if isinstance(b, ast.FunctionDef) and not b.name.startswith("_"):
            out[b.name] = methods[b.name]
        elif isinstance(b, ast.Assign) and isinstance(b.value, ast.Name):
            for t in b.targets:
                if isinstance(t, ast.Name) and not t.id.startswith("_"):
                    out[t.id] = methods.get(b.value.id, [])
    return out


def _surface(tree):
    """Public module-level names of a module: functions → params, classes → their
    surface, constants and imported names → None."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = ("function", _params(node))
        elif isinstance(node, ast.ClassDef):
            out[node.name] = ("class", _class_surface(node))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ("name", None)
        elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                ("denovo_kmer_tpu.", "denovo_kmer_tpu_torch.")):
            rel = node.module.split(".", 1)[1].replace(".", "/") + ".py"
            for a in node.names:
                out[a.asname or a.name] = ("import", (rel, a.name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = ("name", None)
    return out


def _resolved(pkg, surface, name):
    """A surface entry with a re-export (``from <package>.<m> import name``) followed to
    the module that defines it."""
    kind, spec = surface[name]
    while kind == "import" and os.path.exists(os.path.join(pkg, spec[0])):
        rel, name = spec
        kind, spec = _surface(_tree(pkg, rel)).get(name, ("name", None))
    return kind, spec


def _gaps(rel):
    """What the port's module of path ``rel`` lacks of the JAX module's public surface, as
    ALLOWED keys."""
    if not os.path.exists(os.path.join(PORT_PKG, rel)):
        return [rel]
    jax, port = _surface(_tree(JAX_PKG, rel)), _surface(_tree(PORT_PKG, rel))
    gaps = []
    imported = _imported(rel)
    for name, (kind, spec) in jax.items():
        if name.startswith("_") or name in imported:
            continue
        if name not in port:
            gaps.append(f"{rel}:{name}")
            continue
        pkind, pspec = _resolved(PORT_PKG, port, name)
        if kind == "function":
            gaps += [f"{rel}:{name}({p})" for p in spec if pkind != "function" or p not in pspec]
        elif kind == "class":
            if pkind != "class":
                gaps.append(f"{rel}:{name}")
                continue
            for meth, params in spec.items():
                if meth not in pspec:
                    gaps.append(f"{rel}:{name}.{meth}")
                    continue
                gaps += [f"{rel}:{name}.{meth}({p})" for p in params if p not in pspec[meth]]
    return gaps


def _imported(rel):
    """Names the JAX module imports: its dependencies, not its surface (an ``__init__``'s
    exports are held by their own test)."""
    out = set()
    for node in _tree(JAX_PKG, rel).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {a.asname or a.name.split(".")[0] for a in node.names}
    return out


def _jax_all(rel):
    for node in _tree(JAX_PKG, rel).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    return []


def _roadmap_section3():
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        text = f.read()
    start = text.index("### 3.")
    end = text.find("\n## ", start)
    return text[start:] if end < 0 else text[start:end]


@pytest.mark.parametrize("rel", JAX_INITS)
def test_jax_exports_import_from_the_port(rel):
    names = _jax_all(rel)
    package = "denovo_kmer_tpu_torch" + (
        "." + os.path.dirname(rel).replace("/", ".") if os.path.dirname(rel) else "")
    mod = importlib.import_module(package)
    missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, f"{package} lacks {missing}"
    assert set(names) <= set(getattr(mod, "__all__", ())), f"{package}.__all__"


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_module_accepts_the_jax_surface(rel):
    unexplained = [g for g in _gaps(rel) if g not in ALLOWED]
    assert not unexplained, f"the port lacks, with no ROADMAP §3 item: {unexplained}"


@pytest.mark.parametrize("entry", sorted(ALLOWED))
def test_allowed_difference_is_real_and_recorded(entry):
    """Each ALLOWED entry names something of the JAX package that the port lacks (a stale
    entry fails) and its ROADMAP.md §3 item exists."""
    assert ALLOWED[entry] in _roadmap_section3(), f"no ROADMAP §3 item {ALLOWED[entry]!r}"
    rel = entry.split(":")[0]
    assert rel in JAX_MODULES
    m = re.fullmatch(r"([^:]+):(\w+)\.\*_dev", entry)
    if m:  # nested jitted bodies of a JAX class: present there, absent from the port
        def dev_bodies(pkg):
            cls = next(n for n in _tree(pkg, rel).body
                       if isinstance(n, ast.ClassDef) and n.name == m.group(2))
            return [n.name for n in ast.walk(cls)
                    if isinstance(n, ast.FunctionDef) and n.name.endswith("_dev")]
        assert dev_bodies(JAX_PKG) and not dev_bodies(PORT_PKG)
        return
    assert entry in _gaps(rel), f"{entry} is no longer a gap: drop it from ALLOWED"
