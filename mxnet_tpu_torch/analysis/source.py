"""Framework-aware AST linter over the port's sources (``mxnet_tpu_torch/``).

Counterpart of ``mxnet_tpu/analysis/source.py``, with the same rule ids
and the same suppression syntax.  Four rules are plain Python and mean
what they mean in the JAX package:

- ``source.env-undocumented`` ``os.environ`` reads of ``MXNET_TPU_*`` or
                              ``MXTPU_*`` variables missing from the
                              port's catalogue, ``mxnet_tpu_torch/
                              ENV_VARS.md`` (the JAX package's
                              ``docs/env_vars.md`` is its own)
- ``source.env-stale``        catalogued variables nothing in the port
                              reads (its sources, ``chip_smoke.py``,
                              ``tools/torch_*.py``, ``tests/test_torch_*``)
- ``source.unguarded-shared-write``  an attribute declared
                              ``# shared: guarded_by=<lock>`` mutated
                              outside ``with self.<lock>:`` (and outside
                              ``__init__``)
- ``source.daemon-capture``   a ``Thread(daemon=True)`` target closure
                              captures a local the enclosing function
                              rebinds after the thread starts

Three rules have a port meaning.  In JAX "traced" is code under a JAX
tracer; here it is code that runs inside a CUDA-graph capture, where a
host read either fails the capture or is taken once and frozen into
every replay:

- ``source.host-sync``        ``.item()``/``.cpu()``/``.numpy()``/
                              ``.tolist()``/``.asnumpy()``/``float()``/
                              ``np.*`` applied to a captured value, or
                              any ``.synchronize()`` call, inside traced
                              code
- ``source.nondet``           ``time.*``/``random.*``/``np.random.*``/
                              ``datetime.now`` inside traced code: it runs
                              once, at capture, and the replays reuse
                              its value
- ``source.donated-mutation`` reading a buffer after it was donated:
                              ``x.mark_donated(...)``, or ``x`` at a
                              position of the ``donate=`` set of a
                              ``program_key(fingerprint, avals,
                              donate=...)`` call (``avals`` a literal
                              tuple, list or dict, or a name bound to one
                              in the same function; a dict's positions
                              are its values' order), whose static buffer
                              the program's replay overwrites

Traced code is found conservatively, in one file at a time: the body
handed to ``CapturedProgram(label, body, ...)`` (``compile_cache``'s
capture) or to ``make_graphed_callables``, named directly, through
``functools.partial``, or as the functions a lambda calls; the statements
of a ``with torch.cuda.graph(...):`` block; and any def carrying a
``# staticcheck: traced`` directive.  Inside a traced function a simple
taint walk follows the parameters (inside a capture block every local
name counts as captured); accessing ``.shape``/``.dtype``/``.ndim``/
``.size`` *untaints* (shape math on the host is idiomatic and safe).
Functions that a traced body calls are not followed: mark them with the
directive.

The shared-state pass is intraprocedural: only annotate attributes whose
every mutation is *lexically* inside the owning ``with`` block (or in
``__init__``) — helper methods that rely on "caller holds the lock" are
the runtime sanitizer's job (``mxnet_tpu_torch.analysis.concurrency``),
not this one's.

False positives are silenced inline:
``# staticcheck: disable=<rule>[,<rule>] -- <reason>``.
"""

from __future__ import annotations

import ast
import builtins
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .findings import (Finding, Report, apply_inline,
                       parse_inline_suppressions, traced_directive_lines)

__all__ = ["lint_file", "lint_paths", "env_reads_in_source",
           "documented_env_vars", "ENV_PREFIX", "ENV_PREFIXES",
           "ENV_CATALOGUE"]

ENV_PREFIX = "MXNET_TPU_"
#: the port reads the JAX package's prefix and the launcher's
ENV_PREFIXES = ("MXNET_TPU_", "MXTPU_")
#: the port's environment catalogue, relative to the repo root
ENV_CATALOGUE = os.path.join("mxnet_tpu_torch", "ENV_VARS.md")

#: capture entry points -> (position, keyword) of the argument whose
#: function runs under the capture
_TRACERS = {
    "CapturedProgram": (1, "body"),
    "make_graphed_callables": (0, "callables"),
}

#: attribute accesses that *untaint* (static shape/metadata math)
_META_ATTRS = {"shape", "dtype", "ndim", "size", "aval", "sharding",
               "itemsize", "nbytes"}

#: method calls on a traced value that force a host sync
_SYNC_METHODS = {"asnumpy", "asscalar", "item", "tolist", "__float__",
                 "cpu", "numpy"}

#: method calls that synchronize whatever they are called on
_SYNC_ALWAYS = {"synchronize"}

#: builtins that concretize a traced value
_SYNC_BUILTINS = {"float", "int", "bool", "complex"}

_NONDET_MODULES = {"time", "random", "datetime"}

#: builtin names: never captured values in a capture block
_BUILTINS = frozenset(dir(builtins))


def _call_name(node: ast.Call) -> str:
    """Rightmost name of the call target (``jax.lax.scan`` -> ``scan``)."""
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return ""


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains, else ''."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _callable_names(node: ast.AST) -> Iterable[str]:
    """Names of the functions an argument hands over: a name, an
    attribute's last part, ``functools.partial``'s first argument, the
    functions a lambda calls, each element of a tuple or list."""
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, ast.Attribute):
        yield node.attr
    elif isinstance(node, ast.Call) and _call_name(node) == "partial" \
            and node.args:
        yield from _callable_names(node.args[0])
    elif isinstance(node, ast.Lambda):
        for n in ast.walk(node.body):
            if isinstance(n, ast.Call):
                yield from _callable_names(n.func)
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _callable_names(e)


def _is_capture_block(node: ast.With) -> bool:
    """``with torch.cuda.graph(...):`` (any alias ending ``cuda.graph``,
    or a bare ``graph(...)`` imported from ``torch.cuda``)."""
    for item in node.items:
        ctx = item.context_expr
        if isinstance(ctx, ast.Call):
            d = _dotted(ctx.func)
            if d.endswith("cuda.graph") or d == "graph":
                return True
    return False


class _FileIndex(ast.NodeVisitor):
    """One pass collecting defs, import aliases, traced-entry calls and
    capture blocks."""

    def __init__(self):
        self.defs: Dict[str, List[ast.FunctionDef]] = {}
        self.aliases: Dict[str, str] = {}   # local name -> module path
        self.traced_names: Set[str] = set()
        self.calls: List[ast.Call] = []
        self.capture_blocks: List[ast.With] = []

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            self.aliases[a.asname or a.name.split(".")[0]] = a.name

    def visit_ImportFrom(self, node: ast.ImportFrom):
        mod = node.module or ""
        for a in node.names:
            self.aliases[a.asname or a.name] = f"{mod}.{a.name}"

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self.defs.setdefault(node.name, []).append(node)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_With(self, node: ast.With):
        if _is_capture_block(node):
            self.capture_blocks.append(node)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        self.calls.append(node)
        spec = _TRACERS.get(_call_name(node))
        if spec is not None:
            pos, kw = spec
            args = [node.args[pos]] if len(node.args) > pos else []
            args += [k.value for k in node.keywords if k.arg == kw]
            for arg in args:
                self.traced_names.update(_callable_names(arg))
        self.generic_visit(node)


def _is_traced_def(fn: ast.FunctionDef, index: _FileIndex,
                   traced_lines: Sequence[int]) -> bool:
    if fn.name in index.traced_names:
        return True
    for dec in fn.decorator_list:
        d = _dotted(dec if not isinstance(dec, ast.Call) else dec.func)
        if d.split(".")[-1] in _TRACERS:
            return True
    span = range(fn.lineno,
                 (fn.body[0].lineno if fn.body else fn.lineno) + 1)
    return any(line in span for line in traced_lines)


def _module_of(name: str, index: _FileIndex) -> str:
    """Resolve a local alias to its module path root (np -> numpy)."""
    return index.aliases.get(name, name)


class _TaintLinter:
    """Walk one traced function body with parameter taint, or the body
    of a capture block with every local name tainted."""

    def __init__(self, fn: Any, index: _FileIndex, path: str,
                 report: Report, name: Optional[str] = None):
        self.fn = fn
        self.name = name or fn.name
        self.index = index
        self.path = path
        self.report = report
        self.taint_all = isinstance(fn, ast.With)
        self.tainted: Set[str] = set()
        self.untainted: Set[str] = set()
        if not self.taint_all:
            args = fn.args
            names = [a.arg for a in (args.posonlyargs + args.args
                                     + args.kwonlyargs)]
            if args.vararg:
                names.append(args.vararg.arg)
            if args.kwarg:
                names.append(args.kwarg.arg)
            self.tainted = {n for n in names if n != "self"}

    # -- taint of an expression ----------------------------------------

    def _expr_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            if self.taint_all:
                return (node.id not in self.untainted
                        and node.id not in self.index.aliases
                        and node.id not in _BUILTINS)
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _META_ATTRS:
                return False       # shape/dtype math is static
            return self._expr_tainted(node.value)
        if isinstance(node, ast.Call):
            fname = _call_name(node)
            if fname in {"len", "range", "enumerate", "zip", "type",
                         "isinstance", "getattr", "hasattr", "id"}:
                return False
            if isinstance(node.func, ast.Attribute) and \
                    self._expr_tainted(node.func.value):
                return True            # (g * g).sum() is still traced
            return any(self._expr_tainted(a) for a in node.args) or \
                any(self._expr_tainted(kw.value) for kw in node.keywords)
        if isinstance(node, (ast.BinOp,)):
            return self._expr_tainted(node.left) or \
                self._expr_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._expr_tainted(node.operand)
        if isinstance(node, ast.Compare):
            return self._expr_tainted(node.left) or \
                any(self._expr_tainted(c) for c in node.comparators)
        if isinstance(node, ast.Subscript):
            return self._expr_tainted(node.value)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self._expr_tainted(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(self._expr_tainted(v) for v in node.values
                       if v is not None)
        if isinstance(node, ast.IfExp):
            return (self._expr_tainted(node.body)
                    or self._expr_tainted(node.orelse))
        if isinstance(node, ast.Starred):
            return self._expr_tainted(node.value)
        return False

    # -- walk ----------------------------------------------------------

    def run(self):
        for stmt in self.fn.body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs are linted as their own traced regions
        if isinstance(stmt, ast.Assign):
            taint = self._expr_tainted(stmt.value)
            self._scan_expr(stmt.value)
            for tgt in stmt.targets:
                self._bind(tgt, taint)
            return
        if isinstance(stmt, ast.AugAssign):
            self._scan_expr(stmt.value)
            if self._expr_tainted(stmt.value) and \
                    isinstance(stmt.target, ast.Name):
                self.tainted.add(stmt.target.id)
            return
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._scan_expr(stmt.value)
            if stmt.target is not None:
                self._bind(stmt.target, self._expr_tainted(stmt.value))
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                self._stmt(child)
            elif isinstance(child, ast.expr):
                self._scan_expr(child)

    def _bind(self, tgt: ast.AST, taint: bool):
        if isinstance(tgt, ast.Name):
            if taint:
                self.tainted.add(tgt.id)
                self.untainted.discard(tgt.id)
            else:
                self.tainted.discard(tgt.id)
                self.untainted.add(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._bind(e, taint)

    def _scan_expr(self, node: ast.AST):
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                self._check_call(n)

    def _check_call(self, node: ast.Call):
        fname = _call_name(node)
        # a synchronize inside a capture fails it
        if isinstance(node.func, ast.Attribute) and fname in _SYNC_ALWAYS:
            self._add("source.host-sync", node,
                      f"`{_dotted(node.func) or fname}()` inside traced "
                      f"code `{self.name}`: a synchronize under a "
                      "CUDA-graph capture fails the capture")
            return
        # .item()/.cpu()/... on a traced value
        if isinstance(node.func, ast.Attribute) and \
                fname in _SYNC_METHODS and \
                self._expr_tainted(node.func.value):
            self._add("source.host-sync", node,
                      f"`.{fname}()` on a captured value inside traced "
                      f"code `{self.name}` reads the card (the capture "
                      "fails, or every replay reuses the value read once)")
            return
        # float(x)/int(x) on a traced value
        if isinstance(node.func, ast.Name) and \
                node.func.id in _SYNC_BUILTINS and node.args and \
                self._expr_tainted(node.args[0]):
            self._add("source.host-sync", node,
                      f"`{node.func.id}(...)` reads a captured value "
                      f"inside traced code `{self.name}`")
            return
        root = _dotted(node.func).split(".")[0] if _dotted(node.func) \
            else ""
        mod = _module_of(root, self.index) if root else ""
        # np.* applied to traced data (shape math was untainted above)
        if mod.startswith("numpy") and "random" not in _dotted(node.func):
            if any(self._expr_tainted(a) for a in node.args) or any(
                    self._expr_tainted(kw.value) for kw in node.keywords):
                self._add("source.host-sync", node,
                          f"`{_dotted(node.func)}(...)` applied to a "
                          f"captured value inside `{self.name}` — use "
                          "torch ops on the card, or hoist it out of "
                          "the capture")
            return
        # nondeterminism baked into the trace
        dotted = _dotted(node.func)
        if mod.split(".")[0] in _NONDET_MODULES or \
                (mod.startswith("numpy") and ".random." in f".{dotted}."):
            self._add("source.nondet", node,
                      f"`{dotted}(...)` inside traced code `{self.name}` "
                      "runs once, at capture, and every replay reuses its "
                      "value (draw on the card, or pass it in through a "
                      "static input)")

    def _add(self, rule: str, node: ast.AST, message: str):
        self.report.add(Finding(rule, message, path=self.path,
                                line=getattr(node, "lineno", 0)))


# ----------------------------------------------------------------------
# Env-var rules
# ----------------------------------------------------------------------

_ENV_NAME_RE = re.compile(r"\b((?:MXNET_TPU|MXTPU)_[A-Z0-9_]+)\b")


def _env_call_varname(node: ast.Call, consts: Dict[str, str]
                      ) -> Optional[str]:
    """Variable name read by an ``os.environ.get``/``os.getenv`` call, or
    by a local wrapper whose name mentions ``env`` (``_env_flag(...)``,
    ``_env_float(...)``) with a literal first argument."""
    d = _dotted(node.func)
    direct = d.endswith("environ.get") or d.endswith("getenv")
    wrapper = bool(re.search(r"env", _call_name(node), re.IGNORECASE))
    if not (direct or wrapper) or not node.args:
        return None
    a = node.args[0]
    var: Optional[str] = None
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        var = a.value
    elif isinstance(a, ast.Name):
        var = consts.get(a.id)
    if var is not None and not direct and \
            not var.startswith(ENV_PREFIXES):
        return None                    # wrapper heuristic: prefix only
    return var


def env_reads_in_source(src: str, tree: Optional[ast.AST] = None
                        ) -> List[Tuple[str, int]]:
    """All ``MXNET_TPU_*`` and ``MXTPU_*`` env names read in one file:
    ``environ.get``/``getenv`` calls, ``environ[...]`` subscripts, and
    ``in os.environ`` tests — with module-level string constants
    resolved."""
    tree = tree if tree is not None else ast.parse(src)
    consts: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            consts[node.targets[0].id] = node.value.value
    out: List[Tuple[str, int]] = []

    def name_of(expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value
        if isinstance(expr, ast.Name):
            return consts.get(expr.id)
        return None

    for node in ast.walk(tree):
        var: Optional[str] = None
        if isinstance(node, ast.Call):
            var = _env_call_varname(node, consts)
        elif isinstance(node, ast.Subscript) and \
                _dotted(node.value).endswith("environ"):
            var = name_of(node.slice)
        elif isinstance(node, ast.Compare) and len(node.ops) == 1 and \
                isinstance(node.ops[0], (ast.In, ast.NotIn)) and \
                _dotted(node.comparators[0]).endswith("environ"):
            var = name_of(node.left)
        if var and var.startswith(ENV_PREFIXES):
            out.append((var, getattr(node, "lineno", 0)))
    return out


def documented_env_vars(docs_text: str) -> Set[str]:
    return set(_ENV_NAME_RE.findall(docs_text))


# ----------------------------------------------------------------------
# Donated-buffer mutation rule
# ----------------------------------------------------------------------

def _positional_leaves(node: Optional[ast.AST]) -> List[ast.AST]:
    """The positions of a literal ``avals``: a tuple's or list's
    elements, a dict's values in order."""
    if isinstance(node, (ast.Tuple, ast.List)):
        return list(node.elts)
    if isinstance(node, ast.Dict):
        return list(node.values)
    return []


def _lint_donated_mutation(fn: ast.FunctionDef, path: str,
                           report: Report) -> None:
    """Within one function body (statement order, control flow ignored):
    after ``x.mark_donated(...)``, or after ``x`` sits at a donated
    position of a ``program_key(fingerprint, avals, donate=...)`` call
    (the replay of that key's program overwrites ``x``'s static buffer),
    a later read of ``x`` is flagged.  Rebinding ``x`` clears it."""
    donated: Dict[str, int] = {}       # dotted name -> donation line
    literals: Dict[str, ast.AST] = {}  # local name -> literal container

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, (ast.Tuple, ast.List, ast.Dict)):
            literals[node.targets[0].id] = node.value

    def donated_args(call: ast.Call) -> List[ast.AST]:
        if _call_name(call) != "program_key":
            return []
        idxs: Set[int] = set()
        for kw in call.keywords:
            if kw.arg == "donate":
                idxs = {c.value for c in ast.walk(kw.value)
                        if isinstance(c, ast.Constant)
                        and isinstance(c.value, int)
                        and not isinstance(c.value, bool)}
        avals = call.args[1] if len(call.args) > 1 else next(
            (kw.value for kw in call.keywords if kw.arg == "avals"), None)
        if isinstance(avals, ast.Name):
            avals = literals.get(avals.id)
        leaves = _positional_leaves(avals)
        return [leaves[i] for i in sorted(idxs) if i < len(leaves)]

    class _Walk(ast.NodeVisitor):
        def visit_FunctionDef(self, node: ast.FunctionDef):
            if node is fn:          # nested defs are walked on their own
                self.generic_visit(node)

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Call(self, call: ast.Call):
            if isinstance(call.func, ast.Attribute) and \
                    call.func.attr == "mark_donated":
                name = _dotted(call.func.value)
                if name:
                    donated[name] = call.lineno
            for arg in donated_args(call):
                name = _dotted(arg)
                if name:
                    donated[name] = call.lineno
            self.generic_visit(call)

        def visit_Assign(self, node: ast.Assign):
            self.visit(node.value)
            for tgt in node.targets:
                name = _dotted(tgt)
                if name in donated:
                    del donated[name]   # rebound: a fresh buffer

        def visit_Name(self, node: ast.Name):
            self._check(node)

        def visit_Attribute(self, node: ast.Attribute):
            self._check(node)
            self.generic_visit(node)   # reach the inner Name/chain

        def _check(self, node: ast.AST):
            if not isinstance(getattr(node, "ctx", None), ast.Load):
                return
            name = _dotted(node)
            at = donated.get(name)
            if at is not None and node.lineno > at:
                report.add(Finding(
                    "source.donated-mutation",
                    f"`{name}` is read after being donated at line {at} "
                    "— the program's replay overwrites its buffer",
                    path=path, line=node.lineno,
                    details={"donated_at": at}))
                del donated[name]      # one finding per donation site

    _Walk().visit(fn)


# ----------------------------------------------------------------------
# Shared-state discipline: # shared: guarded_by=<lock>
# ----------------------------------------------------------------------

_GUARDED_RE = re.compile(r"#\s*shared:\s*guarded_by=([\w.,]+)")

#: method names that mutate their receiver in place
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "pop",
    "popleft", "popitem", "remove", "clear", "update", "setdefault",
    "add", "discard", "sort", "reverse", "rotate", "move_to_end",
}


def _guard_annotations(src: str) -> Dict[int, List[str]]:
    """``{line: [lock names]}`` for every ``# shared: guarded_by=`` tag."""
    out: Dict[int, List[str]] = {}
    for i, text in enumerate(src.splitlines(), start=1):
        m = _GUARDED_RE.search(text)
        if m:
            out[i] = [g.strip() for g in m.group(1).split(",") if g.strip()]
    return out


def _self_attr(node: ast.AST) -> Optional[str]:
    """``attr`` when node is exactly ``self.<attr>``, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _lint_guarded_by(tree: ast.AST, src: str, path: str,
                     report: Report) -> None:
    """Per class: collect ``self.<attr>`` assignments tagged
    ``# shared: guarded_by=<lock>``, then flag every mutation of a
    tagged attribute that is not lexically inside ``with self.<lock>:``
    — except in ``__init__``, which is single-threaded construction."""
    ann = _guard_annotations(src)
    if not ann:
        return

    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        guards: Dict[str, List[str]] = {}
        for node in ast.walk(cls):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    attr = _self_attr(tgt)
                    if attr is None:
                        continue
                    for line in range(node.lineno,
                                      (node.end_lineno or node.lineno) + 1):
                        if line in ann:
                            guards[attr] = ann[line]
                            break
        if not guards:
            continue

        def _flag(attr, node, fname, kind):
            want = guards[attr]
            report.add(Finding(
                "source.unguarded-shared-write",
                f"`self.{attr}` is declared shared (guarded_by="
                f"{','.join(want)}) but {kind} in `{fname}` outside "
                f"`with self.{want[0]}:`",
                path=path, line=node.lineno,
                details={"attr": attr, "guards": want, "method": fname}))

        def _visit(node, held: Set[str], fname: str):
            """One pass per node, carrying the lexically-held set."""
            def guarded(attr):
                return any(g in held for g in guards[attr])

            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for s in node.body:   # nested def: nothing held inside
                    _visit(s, set(), fname)
                return
            if isinstance(node, ast.With):
                now = set(held)
                for item in node.items:
                    a = _self_attr(item.context_expr)
                    if a is not None:
                        now.add(a)
                    _visit(item.context_expr, held, fname)
                for s in node.body:
                    _visit(s, now, fname)
                return
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    attr = _self_attr(tgt)
                    if attr in guards and not guarded(attr):
                        _flag(attr, node, fname, "rebound")
                    if isinstance(tgt, ast.Subscript):
                        attr = _self_attr(tgt.value)
                        if attr in guards and not guarded(attr):
                            _flag(attr, node, fname, "item-assigned")
            elif isinstance(node, ast.Delete):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript):
                        attr = _self_attr(tgt.value)
                        if attr in guards and not guarded(attr):
                            _flag(attr, node, fname, "item-deleted")
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATORS:
                attr = _self_attr(node.func.value)
                if attr in guards and not guarded(attr):
                    _flag(attr, node, fname,
                          f"mutated via `.{node.func.attr}()`")
            for child in ast.iter_child_nodes(node):
                _visit(child, held, fname)

        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if item.name == "__init__":
                    continue
                for s in item.body:
                    _visit(s, set(), item.name)


# ----------------------------------------------------------------------
# Daemon-thread closure capture
# ----------------------------------------------------------------------

def _lint_daemon_capture(fn: ast.FunctionDef, path: str,
                         report: Report) -> None:
    """Flag ``threading.Thread(target=<nested def>, daemon=True)`` when
    the nested def reads an enclosing local that the enclosing function
    rebinds at a line AFTER the thread starts — the worker races the
    rebind and may see either value."""
    nested: Dict[str, ast.FunctionDef] = {
        n.name: n for n in fn.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    if not nested:
        return
    # locals the enclosing fn rebinds, with every rebind line
    rebinds: Dict[str, List[int]] = {}

    def collect_rebinds(stmts):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                tgts = (stmt.targets if isinstance(stmt, ast.Assign)
                        else [stmt.target])
                for tgt in tgts:
                    for n in ast.walk(tgt):
                        if isinstance(n, ast.Name):
                            rebinds.setdefault(n.id, []).append(stmt.lineno)
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.stmt):
                    collect_rebinds([child])

    collect_rebinds(fn.body)

    for call in ast.walk(fn):
        if not isinstance(call, ast.Call) or _call_name(call) != "Thread":
            continue
        daemon = any(kw.arg == "daemon"
                     and isinstance(kw.value, ast.Constant)
                     and kw.value.value is True
                     for kw in call.keywords)
        if not daemon:
            continue
        target = None
        for kw in call.keywords:
            if kw.arg == "target" and isinstance(kw.value, ast.Name):
                target = kw.value.id
        if call.args and isinstance(call.args[0], ast.Name):
            target = target or call.args[0].id
        worker = nested.get(target or "")
        if worker is None:
            continue
        params = {a.arg for a in (worker.args.posonlyargs
                                  + worker.args.args
                                  + worker.args.kwonlyargs)}
        bound_inside = {n.targets[0].id for n in ast.walk(worker)
                        if isinstance(n, ast.Assign)
                        and isinstance(n.targets[0], ast.Name)}
        reads = {n.id for n in ast.walk(worker)
                 if isinstance(n, ast.Name)
                 and isinstance(n.ctx, ast.Load)}
        captured = reads - params - bound_inside
        for name in sorted(captured):
            late = [ln for ln in rebinds.get(name, ())
                    if ln > call.lineno and ln != worker.lineno]
            if late:
                report.add(Finding(
                    "source.daemon-capture",
                    f"daemon thread target `{target}` captures local "
                    f"`{name}`, which `{fn.name}` rebinds at line "
                    f"{late[0]} after the thread starts — the worker "
                    "races the rebind",
                    path=path, line=call.lineno,
                    details={"local": name, "rebind_line": late[0]}))
                break   # one finding per Thread call is enough


# ----------------------------------------------------------------------
# File / repo entry points
# ----------------------------------------------------------------------

def lint_file(path: str, src: Optional[str] = None,
              rel: Optional[str] = None,
              report: Optional[Report] = None,
              tree: Optional[ast.AST] = None) -> Report:
    """Lint one Python file (traced-region, donation and shared-state
    rules; env rules are repo-level, see :func:`lint_paths`)."""
    report = report if report is not None else Report(mode="lint")
    if src is None:
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
    rel = rel or path
    try:
        tree = tree if tree is not None else ast.parse(src)
    except SyntaxError as e:
        report.add(Finding("source.parse-error",
                           f"file does not parse: {e}", path=rel,
                           line=e.lineno or 0, severity="error"))
        return report
    index = _FileIndex()
    index.visit(tree)
    traced_lines = traced_directive_lines(src)

    start = len(report.findings)
    for defs in index.defs.values():
        for fn in defs:
            if _is_traced_def(fn, index, traced_lines):
                _TaintLinter(fn, index, rel, report).run()
            _lint_donated_mutation(fn, rel, report)
            _lint_daemon_capture(fn, rel, report)
    for block in index.capture_blocks:
        _TaintLinter(block, index, rel, report,
                     name=f"with {_dotted(block.items[0].context_expr.func)}"
                          f"(...) at line {block.lineno}").run()
    _lint_guarded_by(tree, src, rel, report)
    apply_inline(report.findings[start:], parse_inline_suppressions(src))
    return report


def _iter_py(root: str, subdir: str) -> Iterable[str]:
    base = os.path.join(root, subdir)
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _port_extras(root: str) -> List[str]:
    """The port's files outside its package: ``chip_smoke.py``,
    ``tools/torch_*.py`` and ``tests/test_torch_*.py``."""
    out = []
    for sub, pattern in (("tools", r"torch_\w+\.py$"),
                         ("tests", r"test_torch_\w+\.py$")):
        d = os.path.join(root, sub)
        if os.path.isdir(d):
            out += [os.path.join(d, f) for f in sorted(os.listdir(d))
                    if re.match(pattern, f)]
    smoke = os.path.join(root, "chip_smoke.py")
    return out + ([smoke] if os.path.exists(smoke) else [])


def lint_paths(root: str, paths: Optional[Sequence[str]] = None,
               docs_path: Optional[str] = None,
               report: Optional[Report] = None) -> Report:
    """Lint a repo tree: per-file rules over every ``.py`` under
    ``mxnet_tpu_torch/`` (or explicit ``paths``) plus the two repo-level
    env-var drift rules against the port's catalogue
    (``mxnet_tpu_torch/ENV_VARS.md``)."""
    report = report if report is not None else Report(mode="lint")
    if paths is None:
        paths = list(_iter_py(root, "mxnet_tpu_torch"))
    docs_path = docs_path or os.path.join(root, ENV_CATALOGUE)
    docs_rel = os.path.relpath(docs_path, root)

    # env reads are scanned wider than the lint itself: the smoke script,
    # the port's tools and its tests legitimately read catalogued vars,
    # and a var only they read must not register as stale
    env_scan = list(paths)
    env_scan.extend(p for p in _port_extras(root) if p not in set(paths))

    env_reads: Dict[str, Tuple[str, int]] = {}
    lint_set = set(paths)
    for path in env_scan:
        rel = os.path.relpath(path, root)
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
        try:
            tree = ast.parse(src)
        except SyntaxError:
            tree = None
        if path in lint_set:
            lint_file(path, src=src, rel=rel, report=report, tree=tree)
        if tree is None:
            continue
        supp = parse_inline_suppressions(src)
        for var, line in env_reads_in_source(src, tree):
            if path in lint_set:
                env_reads.setdefault(var, (rel, line))
            else:
                env_reads.setdefault(var, ("", 0))  # read outside lint set
            hit = supp.get(line)
            if hit and any(p in ("source.env-undocumented", "source.*")
                           for p in hit[0]):
                env_reads[var] = ("", 0)  # suppressed at the read site

    documented: Set[str] = set()
    if os.path.exists(docs_path):
        with open(docs_path, "r", encoding="utf-8") as f:
            documented = documented_env_vars(f.read())
    start = len(report.findings)
    for var, (rel, line) in sorted(env_reads.items()):
        if var not in documented and rel:
            report.add(Finding(
                "source.env-undocumented",
                f"env var `{var}` is read here but not documented in "
                f"{docs_rel}", path=rel, line=line,
                details={"var": var}))
    for var in sorted(documented - set(env_reads)):
        report.add(Finding(
            "source.env-stale",
            f"{docs_rel} documents `{var}` but no code of the port "
            "reads it", path=docs_rel,
            details={"var": var}))
    report.metrics["lint"] = {
        "files": len(list(paths)),
        "env_reads": sorted(env_reads),
        "env_documented": sorted(documented),
    }
    return report
