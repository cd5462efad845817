"""The port keeps the JAX package's whole surface.

Each JAX module file is one case of each check: its counterpart at the
same path under ``single_algebra_tpu_torch/``; every public module-level
name (``def``, ``class``, assignment, and in an ``__init__.py`` every
package-relative import); every public method of every public class,
defined in the counterpart class or inherited from a class of the port;
every parameter name of every public function and method. The checks
read both packages' sources with ``ast`` and import neither, except the
last, which imports each port ``__init__.py``'s names as a user would.

What the port leaves out on purpose is named below, each with its reason.
"""

from __future__ import annotations

import ast
import functools
import importlib
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = "single_algebra_tpu", "single_algebra_tpu_torch"
JAX_ROOT, PORT_ROOT = ROOT / JAX_PKG, ROOT / PORT_PKG

#: JAX module files with no counterpart in the port, and why.
NO_COUNTERPART = {
    "ops/pallas/__init__.py": "the Pallas kernels' package; the port's kernels are CUDA "
                              "sources in csrc/, bound by ops/cuda_lib.py",
    "ops/pallas/spmm_kernel.py": "the three Pallas kernels, ported to csrc/*.cu behind "
                                 "ops/densify.py and ops/spmm_kernel.py",
    "ops/precise_math.py": "musl log1p / log / expm1 against XLA's ~4,000-ULP float32 "
                           "log1p; torch's own are within 1 ULP (tests/test_precise_math.py "
                           "allows 3)",
    "utils/cache.py": "JAX's persistent compile cache; the port's kernels build once "
                      "into build/kernels/, keyed by source hash",
}

#: JAX module-level names that are JAX machinery, with what replaces them.
JAX_MACHINERY = {
    "MATMUL_PRECISION": "jax.lax.Precision for every matmul; types.precision_policy()",
    "index_dtype": "jnp index dtype by x64 mode; the port's ids are int32 always",
    "matmul_dtype": "jnp dtype of a matmul operand; types.torch_dtype()",
}

#: JAX methods that register a class as a JAX pytree.
PYTREE_METHODS = {"tree_flatten", "tree_unflatten"}

#: JAX parameters with no meaning on the card: Pallas's interpret mode.
JAX_PARAMS = {"interpret"}

#: JAX signatures whose counterpart is another method of the port's class:
#: (file, qualified name) -> (port method, JAX parameters it does not take, why).
MOVED_SIGNATURES = {
    ("sparse/matrix.py", "SparseMatrix.__init__"): (
        "from_ell_arrays", {"h_data"},
        "the JAX constructor takes device ELL arrays; the port's takes host CSR, and "
        "from_ell_arrays builds a device-valued matrix (its host values are pulled "
        "from the device when first needed)",
    ),
}


def _jax_files() -> list[str]:
    return sorted(p.relative_to(JAX_ROOT).as_posix() for p in JAX_ROOT.rglob("*.py"))


JAX_FILES = _jax_files()
PORTED_FILES = [f for f in JAX_FILES if f not in NO_COUNTERPART]
INIT_FILES = [f for f in PORTED_FILES if f.endswith("__init__.py")]


class Module:
    """What a module file binds at top level, from its source."""

    def __init__(self, path: pathlib.Path):
        self.defined: set[str] = set()  # def, class, assignment
        self.relative_imports: set[str] = set()  # from .x import y / from . import y
        self.bound: set[str] = set()  # every top-level name, imports included
        self.imported_from: dict[str, tuple[int, str | None, str]] = {}
        self.functions: dict[str, ast.FunctionDef] = {}
        self.classes: dict[str, ast.ClassDef] = {}
        self.aliases: dict[str, str] = {}  # Name = OtherName
        self._visit(ast.parse(path.read_text()).body)

    def _visit(self, body) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
                self.defined.add(node.name)
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
                self.defined.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for target in targets:
                    for name in ast.walk(target):
                        if isinstance(name, ast.Name):
                            self.defined.add(name.id)
                            if isinstance(node.value, ast.Name):
                                self.aliases[name.id] = node.value.id
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    name = a.asname or a.name
                    self.bound.add(name)
                    self.imported_from[name] = (node.level, node.module, a.name)
                    if node.level:
                        self.relative_imports.add(name)
            elif isinstance(node, ast.Import):
                self.bound.update((a.asname or a.name).split(".")[0] for a in node.names)
            elif isinstance(node, (ast.If, ast.Try)):
                for part in (node.body, node.orelse, *(
                        h.body for h in getattr(node, "handlers", ())),
                        getattr(node, "finalbody", ())):
                    self._visit(part)
        self.bound |= self.defined


@functools.cache
def module(root: pathlib.Path, rel: str) -> Module:
    return Module(root / rel)


def _public(name: str) -> bool:
    return not name.startswith("_")


def _params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    return [n for n in names if n not in ("self", "cls")]


def _resolve_rel(rel: str, level: int, mod: str | None) -> str | None:
    """The file of the port module that ``from <level dots><mod> import``
    in file ``rel`` names, or None where it is not a module of the port."""

    parts = rel.split("/")[:-1]
    if level > len(parts) + 1:
        return None
    base = parts[: len(parts) - (level - 1)]
    target = base + (mod.split(".") if mod else [])
    for cand in ("/".join(target) + ".py", "/".join(target + ["__init__.py"])):
        if (PORT_ROOT / cand).is_file():
            return cand
    return None


def port_class(rel: str, name: str, depth: int = 0):
    """(file, ClassDef) of the port's class ``name`` as file ``rel`` binds it:
    defined there, aliased, or imported from another port module."""

    if depth > 8 or not (PORT_ROOT / rel).is_file():
        return None
    mod = module(PORT_ROOT, rel)
    if name in mod.classes:
        return rel, mod.classes[name]
    if name in mod.aliases:
        return port_class(rel, mod.aliases[name], depth + 1)
    if name in mod.imported_from:
        level, src, orig = mod.imported_from[name]
        if level:
            target = _resolve_rel(rel, level, src)
            if target is not None:
                return port_class(target, orig, depth + 1)
    return None


def port_method(rel: str, cls: ast.ClassDef, name: str, depth: int = 0):
    """The FunctionDef of method ``name`` of the port's class ``cls`` (file
    ``rel``) or of a base class of the port; True where the class binds the
    name otherwise (an assignment in its body); None where it has none."""

    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name == name:
            return node
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if any(isinstance(t, ast.Name) and t.id == name for t in targets):
                return True
    if depth > 8:
        return None
    for base in cls.bases:
        if isinstance(base, ast.Name):
            found = port_class(rel, base.id)
            if found is not None:
                got = port_method(found[0], found[1], name, depth + 1)
                if got is not None:
                    return got
    return None


def jax_public_names(rel: str) -> set[str]:
    mod = module(JAX_ROOT, rel)
    names = set(mod.defined)
    if rel.endswith("__init__.py"):
        names |= mod.relative_imports
    return {n for n in names if _public(n) and n not in JAX_MACHINERY}


def jax_public_methods(cls: ast.ClassDef) -> dict[str, ast.FunctionDef]:
    return {
        node.name: node for node in cls.body
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        and (_public(node.name) or node.name == "__init__")
    }


@pytest.mark.parametrize("rel", JAX_FILES)
def test_module_has_counterpart(rel):
    if rel in NO_COUNTERPART:
        assert NO_COUNTERPART[rel]
        assert not (PORT_ROOT / rel).exists(), f"{rel} was ported: drop it from NO_COUNTERPART"
        return
    assert (PORT_ROOT / rel).is_file(), f"{PORT_PKG}/{rel} is missing"


@pytest.mark.parametrize("rel", PORTED_FILES)
def test_module_level_names(rel):
    port = module(PORT_ROOT, rel)
    missing = sorted(jax_public_names(rel) - port.bound)
    assert not missing, f"{PORT_PKG}/{rel} lacks {missing}"


@pytest.mark.parametrize("rel", PORTED_FILES)
def test_class_methods(rel):
    missing = []
    for cname, cls in module(JAX_ROOT, rel).classes.items():
        if not _public(cname):
            continue
        found = port_class(rel, cname)
        if found is None:
            missing.append(cname)  # test_module_level_names names it too
            continue
        for meth in jax_public_methods(cls):
            if meth in PYTREE_METHODS or not _public(meth):
                continue
            if port_method(*found, meth) is None:
                missing.append(f"{cname}.{meth}")
    assert not missing, f"{PORT_PKG}/{rel} lacks {missing}"


def _signatures(rel: str):
    """(qualified name, JAX FunctionDef) of every public function and every
    public method (and ``__init__``) of every public class of a JAX file."""

    mod = module(JAX_ROOT, rel)
    for name, fn in mod.functions.items():
        if _public(name):
            yield name, fn
    for cname, cls in mod.classes.items():
        if _public(cname):
            for meth, fn in jax_public_methods(cls).items():
                if meth not in PYTREE_METHODS:
                    yield f"{cname}.{meth}", fn


def _port_signature(rel: str, qual: str):
    port = module(PORT_ROOT, rel)
    if "." not in qual:
        fn = port.functions.get(qual)
        if fn is None and qual in port.aliases:
            fn = port.functions.get(port.aliases[qual])
        if fn is None and qual in port.imported_from:
            level, src, orig = port.imported_from[qual]
            target = _resolve_rel(rel, level, src) if level else None
            fn = module(PORT_ROOT, target).functions.get(orig) if target else None
        return fn
    cname, meth = qual.split(".")
    found = port_class(rel, cname)
    got = port_method(*found, meth) if found else None
    return got if isinstance(got, ast.FunctionDef) else None


@pytest.mark.parametrize("rel", PORTED_FILES)
def test_parameter_names(rel):
    missing = []
    for qual, fn in _signatures(rel):
        want = set(_params(fn)) - JAX_PARAMS
        moved = MOVED_SIGNATURES.get((rel, qual))
        if moved is not None:
            qual = f"{qual.split('.')[0]}.{moved[0]}"
            want -= moved[1]
        got = _port_signature(rel, qual)
        if got is None:
            continue  # a missing name or method: the checks above name it
        lacking = sorted(want - set(_params(got)))
        if lacking:
            missing.append(f"{qual}{lacking}")
    assert not missing, f"{PORT_PKG}/{rel}: parameters missing: {missing}"


def test_allowlists_name_real_things():
    assert set(NO_COUNTERPART) <= set(JAX_FILES)
    for (rel, qual), (meth, dropped, why) in MOVED_SIGNATURES.items():
        cname, jmeth = qual.split(".")
        jfn = jax_public_methods(module(JAX_ROOT, rel).classes[cname])[jmeth]
        assert dropped <= set(_params(jfn)) and why
        assert isinstance(_port_signature(rel, f"{cname}.{meth}"), ast.FunctionDef)
    defined = set().union(*(module(JAX_ROOT, f).defined for f in JAX_FILES))
    assert set(JAX_MACHINERY) <= defined


@pytest.mark.parametrize("rel", INIT_FILES)
def test_init_names_import(rel):
    """``from <port package> import <name>`` works for every name that the
    JAX ``__init__.py`` imports from its own package."""

    pkg = ".".join([PORT_PKG, *rel.split("/")[:-1]])
    port = importlib.import_module(pkg)
    failed = []
    for name in sorted(module(JAX_ROOT, rel).relative_imports):
        if hasattr(port, name):
            continue
        try:  # a submodule, as `from pkg import name` would find it
            importlib.import_module(f"{pkg}.{name}")
        except ImportError:
            failed.append(name)
    assert not failed, f"cannot import {failed} from {pkg}"


def test_ops_reexports_build_nothing():
    """The ``ops`` package's re-exports import in a fresh interpreter and
    load no kernel library; its ``__init__`` imports none of the kernel
    modules."""

    imported = set()
    for node in ast.walk(ast.parse((PORT_ROOT / "ops" / "__init__.py").read_text())):
        if isinstance(node, ast.ImportFrom):
            imported |= {node.module, *(a.name for a in node.names)}
    assert not imported & {"cuda_lib", "densify", "spmm_kernel"}
    code = (
        "import sys\n"
        f"from {PORT_PKG}.ops import ell_spmm, ell_spmm_xla, stats\n"
        "assert callable(ell_spmm) and callable(ell_spmm_xla)\n"
        "assert callable(stats.sum_major)\n"
        f"lib = sys.modules.get('{PORT_PKG}.ops.cuda_lib')\n"
        "assert lib is None or not lib._libs, lib._libs\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
