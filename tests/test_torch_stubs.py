"""The port's type stubs hold its runtime classes and the JAX package's stubs.

``pyfastani_tpu_torch/models/_sketch.pyi`` and ``_types.pyi`` are the
typed public surface a checker reads beside ``py.typed``.  Read with
``ast`` and held against ``inspect`` of the runtime objects, case by case:

* stub -> runtime: every class, function, property and attribute the
  stubs declare exists at runtime; a function's parameters have the
  runtime's names and kinds in the runtime's order, and each default the
  stub writes equals the runtime's;
* runtime -> stub: every public method and property of `Sketch`,
  `Mapper` and the result types, and each of their special methods the
  JAX package's stub declares, is declared, so the stubs cannot fall
  behind the code;
* port stub <-> JAX stub: both packages' stubs, parsed as text (the JAX
  package is not imported), declare the same classes, members and
  parameter lists; the one difference allowed is ``backend`` ->
  ``device`` (``Backend`` -> ``Device``);
* shipped: the port's ``package_data`` in ``setup.py`` covers both stubs.
"""

import ast
import builtins
import glob
import inspect
import os
import types

import numpy as np
import pytest

import pyfastani_tpu_torch
from pyfastani_tpu_torch.models import _sketch, _types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT, JAX = "pyfastani_tpu_torch", "pyfastani_tpu"
STUBS = {"_sketch.pyi": _sketch, "_types.pyi": _types}
# the port's names -> the JAX package's
RENAMES = {"device": "backend", "Device": "Backend"}
# the public runtime classes of each stub
PUBLIC = {
    "_sketch.pyi": ("Sketch", "Mapper"),
    "_types.pyi": ("Hit", "MinimizerInfo", "Position", "Minimizers", "MinimizerIndex"),
}
# special methods a stub must declare where the JAX package's stub does
SPECIAL = (
    "__init__", "__getstate__", "__setstate__", "__reduce__", "__eq__", "__repr__",
    "__len__", "__getitem__", "__iter__", "__contains__",
)
_KINDS = inspect.Parameter


def _tree(package: str, stub: str) -> ast.Module:
    path = os.path.join(ROOT, package, "models", stub)
    with open(path) as fh:
        return ast.parse(fh.read(), filename=path)


def _classes(tree) -> dict:
    return {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}


def _members(node) -> dict:
    """``name -> node`` of the functions and annotated attributes declared
    in a class or module body, in order."""
    out = {}
    for n in node.body:
        if isinstance(n, ast.FunctionDef):
            out[n.name] = n
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out[n.target.id] = n
    return out


def _declared(tree, cls: str) -> set:
    """Members of stub class ``cls`` with those of its stub bases."""
    classes = _classes(tree)
    names = set(_members(classes[cls]))
    for base in classes[cls].bases:
        if isinstance(base, ast.Name) and base.id in classes:
            names |= _declared(tree, base.id)
    return names


def _is_property(node) -> bool:
    return isinstance(node, ast.FunctionDef) and any(
        isinstance(d, ast.Name) and d.id == "property" for d in node.decorator_list
    )


def _params(fn: ast.FunctionDef):
    """``[(name, kind, default node or None)]`` of a stub function."""
    a = fn.args
    positional = [(p, _KINDS.POSITIONAL_ONLY) for p in a.posonlyargs]
    positional += [(p, _KINDS.POSITIONAL_OR_KEYWORD) for p in a.args]
    defaults = [None] * (len(positional) - len(a.defaults)) + list(a.defaults)
    out = [(p.arg, kind, d) for (p, kind), d in zip(positional, defaults)]
    if a.vararg:
        out.append((a.vararg.arg, _KINDS.VAR_POSITIONAL, None))
    out += [(p.arg, _KINDS.KEYWORD_ONLY, d) for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    if a.kwarg:
        out.append((a.kwarg.arg, _KINDS.VAR_KEYWORD, None))
    return out


def _runtime(klass, name):
    """The attribute ``name`` as a class of the port defines it (not as
    ``object`` does), looked up without running descriptors."""
    for base in klass.__mro__:
        if base is object:
            break
        if name in vars(base):
            return vars(base)[name]
    return None


def _stub_cases():
    for stub in STUBS:
        tree = _tree(PORT, stub)
        for name in _members(tree):
            yield stub, None, name
        for cls, node in _classes(tree).items():
            for name in _members(node):
                yield stub, cls, name


def _runtime_cases():
    for stub, classes in PUBLIC.items():
        jax_tree = _tree(JAX, stub)
        for cls in classes:
            klass = getattr(STUBS[stub], cls)
            names = {n for n in dir(klass) if not n.startswith("_")}
            names |= {n for n in SPECIAL if n in _declared(jax_tree, cls)}
            for name in sorted(names):
                yield stub, cls, name


def _parity_cases():
    for stub in STUBS:
        port, jax = _classes(_tree(PORT, stub)), _classes(_tree(JAX, stub))
        for cls in sorted(set(port) | set(jax)):
            names = set(_members(port[cls])) if cls in port else set()
            names |= set(_members(jax[cls])) if cls in jax else set()
            for name in sorted(names):
                yield stub, cls, RENAMES.get(name, name)


def _case_id(case):
    stub, cls, name = case
    return f"{stub}::{cls or '<module>'}.{name}"


@pytest.fixture(scope="module")
def instances():
    """A `Sketch` and a `Mapper` on the CPU, for the attributes a stub
    declares on instances."""
    sketch = pyfastani_tpu_torch.Sketch(device="cpu")
    rng = np.random.default_rng(3)
    sketch.add_genome("g0", rng.choice(np.frombuffer(b"ACGT", np.uint8), 20_000).tobytes())
    return {"Sketch": pyfastani_tpu_torch.Sketch(device="cpu"), "Mapper": sketch.index()}


@pytest.mark.parametrize("case", list(_stub_cases()), ids=_case_id)
def test_stub_member_exists_at_runtime_with_its_signature(case, instances):
    stub, cls, name = case
    module = STUBS[stub]
    tree = _tree(PORT, stub)
    node = _members(_classes(tree)[cls] if cls else tree)[name]
    if cls is None:
        # a module constant of a builtin type
        assert isinstance(getattr(module, name), getattr(builtins, node.annotation.id))
        return
    klass = getattr(module, cls)
    if isinstance(node, ast.AnnAssign):
        # an attribute each instance sets
        assert isinstance(node.annotation, ast.Name)
        assert isinstance(getattr(instances[cls], name), getattr(module, node.annotation.id))
        return
    attr = _runtime(klass, name)
    assert attr is not None, f"{cls}.{name} is not defined at runtime"
    if _is_property(node):
        assert isinstance(attr, (property, types.MemberDescriptorType)), type(attr)
        return
    assert inspect.isfunction(attr), type(attr)
    runtime = list(inspect.signature(attr).parameters.values())
    declared = _params(node)
    assert [(n, k) for n, k, _ in declared] == [(p.name, p.kind) for p in runtime]
    for (pname, _, default), param in zip(declared, runtime):
        assert (default is None) == (param.default is _KINDS.empty), pname
        if default is not None:
            value = ast.literal_eval(default)
            assert type(param.default) is type(value) and param.default == value, pname


@pytest.mark.parametrize("case", list(_runtime_cases()), ids=_case_id)
def test_runtime_member_is_declared_in_the_stub(case):
    stub, cls, name = case
    assert name in _declared(_tree(PORT, stub), cls), f"{cls}.{name} is missing from {stub}"


class _Rename(ast.NodeTransformer):
    """The port's stub with the port's names put back to the JAX
    package's, and its docstrings dropped."""

    def visit_arg(self, node):
        node.arg = RENAMES.get(node.arg, node.arg)
        return self.generic_visit(node)

    def visit_Name(self, node):
        node.id = RENAMES.get(node.id, node.id)
        return node

    def visit_Expr(self, node):
        if isinstance(node.value, ast.Constant) and isinstance(node.value.value, str):
            return None
        return node


def _dump(node) -> str:
    return ast.dump(node, include_attributes=False)


@pytest.mark.parametrize("case", list(_parity_cases()), ids=_case_id)
def test_port_stub_member_equals_the_jax_stub(case):
    stub, cls, name = case
    port = _classes(_Rename().visit(_tree(PORT, stub)))
    jax = _classes(_tree(JAX, stub))
    assert cls in port and cls in jax, cls
    got, want = _members(port[cls]), _members(jax[cls])
    assert name in got and name in want, name
    assert _dump(got[name]) == _dump(want[name])


@pytest.mark.parametrize("stub", sorted(STUBS))
def test_port_stub_module_equals_the_jax_stub(stub):
    """The same classes with the same bases and members in the same order,
    the same module-level names, and the same values but for the one
    alias that differs (``Device`` for ``Backend``)."""
    port = _Rename().visit(_tree(PORT, stub))
    jax = _tree(JAX, stub)
    port_classes, jax_classes = _classes(port), _classes(jax)
    assert list(port_classes) == list(jax_classes)
    for cls in jax_classes:
        assert [_dump(b) for b in port_classes[cls].bases] == [_dump(b) for b in jax_classes[cls].bases]
        assert list(_members(port_classes[cls])) == list(_members(jax_classes[cls]))

    def module_level(tree):
        out = {}
        for n in tree.body:
            if isinstance(n, ast.Assign) and len(n.targets) == 1:
                out[n.targets[0].id] = _dump(n.value)
            elif isinstance(n, ast.AnnAssign):
                out[n.target.id] = _dump(n.annotation)
            elif isinstance(n, ast.ImportFrom) and n.level:
                out[f"from {'.' * n.level}{n.module}"] = _dump(n)
        return out

    got, want = module_level(port), module_level(jax)
    assert got.keys() == want.keys()
    differ = {k for k in want if got[k] != want[k]}
    assert differ <= {"Backend"}, differ


def test_stubs_are_shipped():
    with open(os.path.join(ROOT, "setup.py")) as fh:
        tree = ast.parse(fh.read())
    (call,) = [
        n for n in ast.walk(tree)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and n.func.id == "setup"
    ]
    package_data = ast.literal_eval(next(k.value for k in call.keywords if k.arg == "package_data"))
    shipped = set()
    for pattern in package_data[PORT]:
        shipped |= {
            os.path.relpath(p, os.path.join(ROOT, PORT))
            for p in glob.glob(os.path.join(ROOT, PORT, pattern), recursive=True)
        }
    stubs = {
        os.path.relpath(p, os.path.join(ROOT, PORT))
        for p in glob.glob(os.path.join(ROOT, PORT, "**", "*.pyi"), recursive=True)
    }
    assert stubs == {os.path.join("models", s) for s in STUBS}
    assert stubs <= shipped
