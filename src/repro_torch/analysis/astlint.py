"""AST lint pass: the port's rules on stdlib ``ast`` only (the twin of
``repro.analysis.astlint``).

What plays the role of a jit site is a *captured body*: a callable the
port records once and replays, so that a host read inside it either breaks
a CUDA-graph capture or bakes a stale value into every replay:

- the ``fn`` handed to ``DeviceSparwEngine._program(key, fn)`` or to
  ``TickProgram(fn, ...)`` (``core/engine.py``): a lambda, a def of the
  module, or a bound ``self.method``; a lambda whose body is one call to a
  def of the same module (``lambda: self._render_windows(...)``) counts
  that def as its body too;
- the statements of a ``with torch.cuda.graph(...)`` block;
- a ``torch.compile`` target (decorated, or passed to ``torch.compile``).

Rules (ids are stable — tests and suppressions key on them):

- ``graph-tensor-bool-if``    a Python ``if``/``while``/conditional
                              expression/``assert`` in a captured body whose
                              test calls ``torch.*`` or a tensor method
                              (twin of ``jit-traced-bool-if``).
- ``graph-host-sync``         ``.item()``/``.tolist()``/``.cpu()``/
                              ``.numpy()``, ``np.asarray``/``np.array``,
                              ``torch.cuda.synchronize`` or ``int()``/
                              ``float()``/``bool()`` of a tensor-valued name
                              inside a captured body (twin of
                              ``jit-host-sync``).
- ``graph-key-missing``       a ``_program(key, fn)`` whose ``fn`` reads a
                              shape-shaping name (``s``, ``n``, ``bucket``,
                              ...) that the key tuple does not hold: a stale
                              graph would replay at a new shape (twin of
                              ``jit-missing-static``).
- ``raw-hash``                builtin ``hash()`` outside ``__hash__``.
- ``mutable-default-frozen``  mutable default on a frozen dataclass field.
- ``kernel-no-plain-route``   a function launching a ``CudaKernel`` (a
                              ``.call(`` on a ``KERNEL*`` object) that is
                              not routed — neither branching on
                              ``device.type`` itself (CPU to the plain
                              version, any other device but CUDA raising)
                              nor called only from routed functions of its
                              module — or a launch inside a ``try`` whose
                              handler does anything but re-raise: the
                              quiet fallback the port forbids (twin of
                              ``pallas-no-interpret``).

Scope: captured bodies are scanned directly, not the functions they call
(beyond the one forwarding lambda above); the program pass covers those by
running the bodies. See README.md.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.findings import Finding

# Names that shape a tick program anywhere in the port: the key of
# ``_program`` must hold each one its ``fn`` reads, or a program captured at
# one value replays at another.
SHAPE_NAMES: frozenset = frozenset({
    "s", "n", "bucket", "bucket_coarse", "num_seg", "num_samples",
    "quantum",
})

_HOST_NP_ROOTS = {"np", "numpy", "onp"}
_SCALARIZERS = {"int", "float", "bool", "complex"}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
# tensor methods whose value is a tensor (a bool test on one reads it)
_TENSOR_METHODS = {
    "any", "all", "sum", "prod", "max", "min", "amax", "amin", "mean",
    "norm", "item", "eq", "ne", "gt", "lt", "ge", "le", "equal",
    "allclose", "isnan", "isfinite", "isinf", "count_nonzero", "nonzero",
    "argmax", "argmin", "abs",
}
# attribute reads / calls of a tensor that give host values, not tensors
_STATIC_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout"}
_STATIC_METHODS = {"size", "dim", "numel", "element_size", "data_ptr",
                   "stride", "is_contiguous", "get_device"}
_KERNEL_RE = re.compile(r"^KERNEL")


def _attr_root(node: ast.AST) -> Optional[str]:
    """Root Name of a dotted attribute chain (``torch.cuda.graph`` ->
    ``torch``)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _dotted(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _func_params(fn: ast.AST) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs] + [p.arg for p in a.args]
    return names + [p.arg for p in a.kwonlyargs]


def _owners(tree: ast.Module) -> Dict[int, ast.AST]:
    """id(node) -> the innermost function def enclosing it, in one
    descent."""
    owner: Dict[int, ast.AST] = {}

    def visit(node: ast.AST, fn: Optional[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            if fn is not None:
                owner[id(child)] = fn
            visit(child, child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn)

    visit(tree, None)
    return owner


class _Index:
    """One walk of a module: its nodes by kind, the defs by name."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.calls: List[ast.Call] = []
        self.defs: Dict[str, ast.AST] = {}
        self.fns: List[ast.AST] = []
        self.withs: List[ast.AST] = []
        self.trys: List[ast.Try] = []
        self.classes: List[ast.ClassDef] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                self.calls.append(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs.setdefault(node.name, node)
                self.fns.append(node)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                self.withs.append(node)
            elif isinstance(node, ast.Try):
                self.trys.append(node)
            elif isinstance(node, ast.ClassDef):
                self.classes.append(node)


def _is_tensor_annotation(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    return any((isinstance(sub, ast.Attribute) and sub.attr == "Tensor")
               or (isinstance(sub, ast.Name) and sub.id == "Tensor")
               for sub in ast.walk(ann))


# ---------------------------------------------------------------------------
# captured bodies
# ---------------------------------------------------------------------------


class _Body:
    """One captured body: the nodes to scan (a def, a lambda, or the
    statements of a ``with torch.cuda.graph`` block) and its anchor."""

    def __init__(self, nodes: List[ast.AST], line: int, col: int,
                 tensor_params: Iterable[str] = ()):
        self.nodes = nodes
        self.line, self.col = line, col
        self.tensor_params = set(tensor_params)


def _body_of_def(fn: ast.AST, line: int, col: int) -> _Body:
    if isinstance(fn, ast.Lambda):
        return _Body([fn.body], line, col)
    a = fn.args
    tensors = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
               if _is_tensor_annotation(p.annotation)]
    return _Body(list(fn.body), line, col, tensors)


def _callee_def(call: ast.AST, defs: Dict[str, ast.AST]
                ) -> Optional[ast.AST]:
    """The def of the module a call names (``f(...)``, ``self.f(...)``)."""
    if not isinstance(call, ast.Call):
        return None
    f = call.func
    if isinstance(f, ast.Name):
        return defs.get(f.id)
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "self":
        return defs.get(f.attr)
    return None


def _target_bodies(target: ast.AST, defs: Dict[str, ast.AST], line: int,
                   col: int) -> List[_Body]:
    """The bodies of a callable handed to a capture site."""
    if isinstance(target, ast.Lambda):
        out = [_body_of_def(target, line, col)]
        fwd = _callee_def(target.body, defs)
        if fwd is not None:
            out.append(_body_of_def(fwd, line, col))
        return out
    if isinstance(target, ast.Name) and target.id in defs:
        return [_body_of_def(defs[target.id], line, col)]
    if isinstance(target, ast.Attribute) and target.attr in defs \
            and isinstance(target.value, ast.Name) \
            and target.value.id == "self":
        return [_body_of_def(defs[target.attr], line, col)]
    return []


def _is_torch_compile(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "compile" \
        and _attr_root(node) == "torch"


def _call_arg(call: ast.Call, index: int, name: str) -> Optional[ast.AST]:
    if len(call.args) > index:
        return call.args[index]
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _program_sites(ix: _Index) -> List[Tuple[ast.Call, ast.AST, ast.AST]]:
    """Every ``X._program(key, fn)`` call: (call, key, fn)."""
    out = []
    for node in ix.calls:
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "_program":
            key, fn = _call_arg(node, 0, "key"), _call_arg(node, 1, "fn")
            if key is not None and fn is not None:
                out.append((node, key, fn))
    return out


def collect_bodies(tree) -> List[_Body]:
    """Every captured body of a module (see the module docstring)."""
    ix = tree if isinstance(tree, _Index) else _Index(tree)
    defs = ix.defs
    bodies: List[_Body] = []
    for call, _, fn in _program_sites(ix):
        bodies += _target_bodies(fn, defs, call.lineno, call.col_offset)
    for node in ix.calls:
        f = node.func
        is_tick = (isinstance(f, ast.Name) and f.id == "TickProgram") \
            or (isinstance(f, ast.Attribute) and f.attr == "TickProgram")
        if is_tick or _is_torch_compile(f):
            fn = _call_arg(node, 0, "fn" if is_tick else "model")
            if fn is not None:
                bodies += _target_bodies(fn, defs, node.lineno,
                                         node.col_offset)
    for node in ix.fns:
        for dec in node.decorator_list:
            d = dec.func if isinstance(dec, ast.Call) else dec
            if _is_torch_compile(d):
                bodies.append(_body_of_def(node, node.lineno,
                                           node.col_offset))
    for node in ix.withs:
        for item in node.items:
            e = item.context_expr
            if isinstance(e, ast.Call) and _dotted(e.func) in (
                    "torch.cuda.graph", "cuda.graph"):
                bodies.append(_Body(list(node.body), node.lineno,
                                    node.col_offset))
    return bodies


# ---------------------------------------------------------------------------
# per-rule checks
# ---------------------------------------------------------------------------


def _walk(nodes: Iterable[ast.AST]) -> Iterable[ast.AST]:
    for n in nodes:
        yield from ast.walk(n)


def _tensor_call(node: ast.AST) -> bool:
    """A call whose value is a tensor: ``torch.*(...)`` or a tensor
    method."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if _attr_root(f) == "torch" and isinstance(f, ast.Attribute):
        return True
    return isinstance(f, ast.Attribute) and f.attr in _TENSOR_METHODS


def _contains_tensor_call(node: ast.AST) -> Optional[ast.Call]:
    for sub in ast.walk(node):
        if _tensor_call(sub):
            return sub
    return None


def _reads_tensor(expr: ast.AST, tensors: Set[str]) -> bool:
    """Whether ``expr`` has a tensor value: a tensor call, or a read of a
    tensor-valued name other than through a static attribute
    (``.shape``, ``.numel()``, ``len()``, ...)."""
    static: Set[int] = set()
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
            static.update(id(s) for s in ast.walk(sub.value))
        elif isinstance(sub, ast.Call):
            f = sub.func
            if isinstance(f, ast.Attribute) and f.attr in _STATIC_METHODS:
                static.update(id(s) for s in ast.walk(f.value))
            elif isinstance(f, ast.Name) and f.id == "len":
                static.update(id(s) for a in sub.args for s in ast.walk(a))
    for sub in ast.walk(expr):
        if id(sub) in static:
            continue
        if _tensor_call(sub):
            return True
        if isinstance(sub, ast.Name) and sub.id in tensors:
            return True
    return False


def _assigned_names(target: ast.AST) -> List[str]:
    return [t.id for t in ast.walk(target) if isinstance(t, ast.Name)]


def tensor_names(body: _Body) -> Set[str]:
    """Names the body reads from a tensor: its tensor-annotated params and
    every name assigned a tensor-valued expression (to a fixpoint)."""
    names = set(body.tensor_params)
    assigns = []
    for node in _walk(body.nodes):
        if isinstance(node, ast.Assign):
            assigns.append((node.targets, node.value))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                and node.value is not None:
            assigns.append(([node.target], node.value))
        elif isinstance(node, ast.NamedExpr):
            assigns.append(([node.target], node.value))
    changed = True
    while changed:
        changed = False
        for targets, value in assigns:
            if _reads_tensor(value, names):
                for t in targets:
                    for name in _assigned_names(t):
                        if name not in names:
                            names.add(name)
                            changed = True
    return names


def _check_body(body: _Body, path: str) -> Iterable[Finding]:
    tensors = tensor_names(body)
    for node in _walk(body.nodes):
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            bad = _contains_tensor_call(node.test)
            if bad is not None:
                yield Finding(
                    "graph-tensor-bool-if", path, node.lineno,
                    node.col_offset,
                    "Python control flow on a tensor expression inside a "
                    "captured body: it reads the device at capture and "
                    "replays that one branch — use torch.where or hoist "
                    "the decision into the program's key")
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _HOST_METHODS \
                and not (f.attr == "cpu" and _attr_root(f) == "torch"):
            yield Finding(
                "graph-host-sync", path, node.lineno, node.col_offset,
                f".{f.attr}() inside a captured body copies a tensor to "
                "the host: it synchronizes (a capture refuses it) and a "
                "replay would not repeat it")
        elif isinstance(f, ast.Attribute) and f.attr in {"asarray", "array"} \
                and _attr_root(f) in _HOST_NP_ROOTS:
            yield Finding(
                "graph-host-sync", path, node.lineno, node.col_offset,
                f"np.{f.attr}() inside a captured body materializes a "
                "tensor on the host — keep it in torch")
        elif _dotted(f) == "torch.cuda.synchronize":
            yield Finding(
                "graph-host-sync", path, node.lineno, node.col_offset,
                "torch.cuda.synchronize() inside a captured body waits on "
                "the host")
        elif isinstance(f, ast.Name) and f.id in _SCALARIZERS and node.args:
            arg = node.args[0]
            if (isinstance(arg, ast.Name) and arg.id in tensors) \
                    or _tensor_call(arg):
                what = arg.id if isinstance(arg, ast.Name) else "a tensor"
                yield Finding(
                    "graph-host-sync", path, node.lineno, node.col_offset,
                    f"{f.id}({what}) reads a tensor on the host inside a "
                    "captured body — keep it on the device or make it a "
                    "key of the program")


def _free_reads(fn: ast.AST) -> Set[str]:
    """Names a lambda or def reads that it does not bind itself."""
    bound = set(_func_params(fn)) if hasattr(fn, "args") else set()
    body = [fn.body] if isinstance(fn, ast.Lambda) else list(fn.body)
    for node in _walk(body):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            bound.add(node.id)
    return {node.id for node in _walk(body)
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
            and node.id not in bound}


def _key_names(key: ast.AST, scope: Optional[ast.AST]) -> Optional[Set[str]]:
    """The names a key tuple holds; a Name key is resolved through its
    assignment in the enclosing function (None where it cannot be)."""
    if isinstance(key, ast.Name) and scope is not None:
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == key.id
                    for t in node.targets):
                key = node.value
                break
    if not isinstance(key, ast.Tuple):
        return None
    return {n.id for e in key.elts for n in ast.walk(e)
            if isinstance(n, ast.Name)}


def _check_program_keys(ix: _Index, path: str) -> Iterable[Finding]:
    defs = ix.defs
    sites = _program_sites(ix)
    scope_of = _owners(ix.tree) if sites else {}
    for call, key, fn in sites:
        if isinstance(fn, ast.Name) and fn.id in defs:
            fn = defs[fn.id]
        if not isinstance(fn, (ast.Lambda, ast.FunctionDef,
                               ast.AsyncFunctionDef)):
            continue
        held = _key_names(key, scope_of.get(id(call)))
        if held is None:
            continue
        missing = sorted((_free_reads(fn) & SHAPE_NAMES) - held)
        if missing:
            yield Finding(
                "graph-key-missing", path, call.lineno, call.col_offset,
                f"tick program's fn reads shape-shaping name(s) "
                f"{', '.join(missing)} that its key does not hold — a "
                "graph captured at one value would replay at another")


def _check_raw_hash(ix: _Index, path: str) -> Iterable[Finding]:
    hash_owners: Set[int] = set()  # id() of nodes under a __hash__ def
    for node in ix.fns:
        if (isinstance(node, ast.FunctionDef) and node.name == "__hash__"):
            hash_owners.update(id(sub) for sub in ast.walk(node))
    for node in ix.calls:
        if (isinstance(node.func, ast.Name)
                and node.func.id == "hash" and id(node) not in hash_owners):
            yield Finding(
                "raw-hash", path, node.lineno, node.col_offset,
                "builtin hash() is randomized per process "
                "(PYTHONHASHSEED) — derive seeds/cache keys from "
                "zlib.crc32 or hashlib instead (see utils.fold_seed)")


_MUTABLE_CTORS = {"list", "dict", "set", "bytearray"}


def _is_mutable_default(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in _MUTABLE_CTORS:
            return True
        if (isinstance(f, ast.Attribute) and f.attr in {"array", "zeros",
                                                        "ones", "empty"}):
            return True
    return False


def _check_frozen_defaults(ix: _Index, path: str) -> Iterable[Finding]:
    for cls in ix.classes:
        frozen = False
        for dec in cls.decorator_list:
            if isinstance(dec, ast.Call):
                is_dc = ((isinstance(dec.func, ast.Name)
                          and dec.func.id == "dataclass")
                         or (isinstance(dec.func, ast.Attribute)
                             and dec.func.attr == "dataclass"))
                if is_dc and any(kw.arg == "frozen"
                                 and isinstance(kw.value, ast.Constant)
                                 and kw.value.value is True
                                 for kw in dec.keywords):
                    frozen = True
        if not frozen:
            continue
        for stmt in cls.body:
            if not isinstance(stmt, ast.AnnAssign) or stmt.value is None:
                continue
            default = stmt.value
            if (isinstance(default, ast.Call)
                    and ((isinstance(default.func, ast.Name)
                          and default.func.id == "field")
                         or (isinstance(default.func, ast.Attribute)
                             and default.func.attr == "field"))):
                for kw in default.keywords:
                    if kw.arg == "default":
                        default = kw.value
                        break
                else:
                    continue
            if _is_mutable_default(default):
                yield Finding(
                    "mutable-default-frozen", path, stmt.lineno,
                    stmt.col_offset,
                    "mutable default on a frozen dataclass field — shared "
                    "across instances and breaks the hashability the "
                    "config/fingerprint contract relies on")


def _is_launch(node: ast.AST) -> bool:
    """``KERNEL*.call(...)``: a ``CudaKernel`` launch."""
    if not (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
            and node.func.attr == "call"):
        return False
    obj = node.func.value
    name = obj.id if isinstance(obj, ast.Name) else (
        obj.attr if isinstance(obj, ast.Attribute) else "")
    return bool(_KERNEL_RE.match(name))


def _device_type_test(test: ast.AST, op, value: str) -> bool:
    """``<x>.device.type <op> "<value>"``."""
    return (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], op)
            and isinstance(test.left, ast.Attribute)
            and test.left.attr == "type"
            and isinstance(test.left.value, ast.Attribute)
            and test.left.value.attr == "device"
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value == value)


def _routes_itself(fn: ast.AST) -> bool:
    """``if x.device.type == "cpu": return <plain>`` and ``if
    x.device.type != "cuda": raise`` in ``fn``."""
    plain = other = False
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        if _device_type_test(node.test, ast.Eq, "cpu") and any(
                isinstance(s, ast.Return) and s.value is not None
                for s in node.body):
            plain = True
        if _device_type_test(node.test, ast.NotEq, "cuda") and any(
                isinstance(s, ast.Raise) for s in node.body):
            other = True
    return plain and other


def _check_kernel_routes(ix: _Index, path: str) -> Iterable[Finding]:
    launches = [n for n in ix.calls if _is_launch(n)]
    if not launches:
        return
    owner = _owners(ix.tree)
    callers: Dict[str, List[ast.AST]] = {}
    for node in ix.calls:
        f = node.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        if name is not None:
            callers.setdefault(name, []).append(owner.get(id(node)))

    memo: Dict[int, bool] = {}

    def routed(fn: Optional[ast.AST], seen: Tuple[int, ...] = ()) -> bool:
        if fn is None or id(fn) in seen:
            return False
        if id(fn) not in memo:
            if _routes_itself(fn):
                memo[id(fn)] = True
            else:
                sites = callers.get(fn.name, [])
                memo[id(fn)] = bool(sites) and all(
                    routed(c, seen + (id(fn),)) for c in sites)
        return memo[id(fn)]

    bad_try: Set[int] = set()
    for node in ix.trys:
        quiet = any(not (len(h.body) == 1 and isinstance(h.body[0],
                                                         ast.Raise)
                         and h.body[0].exc is None)
                    for h in node.handlers)
        if quiet:
            for stmt in node.body:
                bad_try.update(id(s) for s in ast.walk(stmt))
    for node in launches:
        if id(node) in bad_try:
            yield Finding(
                "kernel-no-plain-route", path, node.lineno, node.col_offset,
                "CUDA kernel launch inside a try whose handler does more "
                "than re-raise — a failed launch must raise, never fall "
                "back quietly")
        elif not routed(owner.get(id(node))):
            yield Finding(
                "kernel-no-plain-route", path, node.lineno, node.col_offset,
                "CUDA kernel launch in a function that is not routed by "
                "device: a CPU tensor must take the plain version and any "
                "other device but CUDA raise (if x.device.type == 'cpu': "
                "return plain(...); if x.device.type != 'cuda': raise)")


ALL_RULES = ("graph-tensor-bool-if", "graph-host-sync", "graph-key-missing",
             "raw-hash", "mutable-default-frozen", "kernel-no-plain-route")


def lint_source(src: str, path: str) -> List[Finding]:
    """Run every AST rule on one module's source. ``path`` is the
    repo-relative anchor used in findings."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding("syntax-error", path, e.lineno or 1, 0, str(e))]
    ix = _Index(tree)
    out: List[Finding] = []
    seen: Set[Tuple] = set()
    for body in collect_bodies(ix):
        for f in _check_body(body, path):
            key = (f.rule, f.line, f.col)  # a def captured at 2 sites
            if key not in seen:
                seen.add(key)
                out.append(f)
    out.extend(_check_program_keys(ix, path))
    out.extend(_check_raw_hash(ix, path))
    out.extend(_check_frozen_defaults(ix, path))
    out.extend(_check_kernel_routes(ix, path))
    return out


def lint_paths(root: Path, rel_paths: Iterable[str]) -> List[Finding]:
    out: List[Finding] = []
    for rel in rel_paths:
        p = root / rel
        try:
            src = p.read_text()
        except OSError:
            continue
        out.extend(lint_source(src, rel))
    return out
