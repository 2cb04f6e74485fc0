"""Concurrency lint: an AST pass over the port's sources, ``chip_smoke.py``
and the port's tests (counterpart of deeplearning4j_tpu/analysis/
concurrency.py, finding for finding the same pass).

Four hazard classes, each a documented finding code (analysis/__init__.py
``CODES``):

- **DL4J-C001** — ``lock.acquire()`` with no guaranteed release: the
  call is neither inside a ``try`` whose ``finally`` releases the same
  receiver, nor the statement immediately before one. A raise between
  acquire and release leaves the lock held forever; ``with`` is free.
- **DL4J-C002 / DL4J-C003** — untimed blocking calls: zero-argument
  ``.get()`` (queue), ``.join()`` (thread), ``.result()`` (future) and
  ``urlopen(...)`` without ``timeout=``. C002 when a lock is lexically
  held (``with <lock>:`` in scope, or the enclosing function follows
  the ``*_locked`` naming convention) — a blocked holder starves every
  other thread; C003 anywhere else — a dead producer/fleet hangs the
  caller forever instead of surfacing an error.
- **DL4J-C004** — ``threading.Thread(...)`` that is neither
  ``daemon=True`` nor marked daemon in the enclosing function: a
  forgotten non-daemon thread blocks interpreter shutdown.
- **DL4J-C005** — a write (assignment, augmented assignment, item
  write/delete, or mutator call such as ``.append``/``.clear``) to an
  attribute registered via ``@guarded_by`` (analysis/guards.py)
  outside ``with self.<lock>:``. ``__init__`` and ``*_locked`` methods
  are exempt.

Intentional exceptions are suppressed inline with ``# analysis: ok`` on
the offending line (optionally ``# analysis: ok(C003) — reason``);
everything else lands in the findings list that ``python -m
deeplearning4j_tpu_torch.analysis`` gates against ``analysis/baseline.json``.

The pass is purely lexical — it never imports the code under analysis,
so it runs in milliseconds over the full tree and can lint broken or
heavyweight modules alike.
"""

from __future__ import annotations

import ast
import glob
import os
import re
from typing import Dict, List, Optional, Set

from deeplearning4j_tpu_torch.analysis import Finding

__all__ = ["lint_source", "lint_file", "lint_tree", "lint_tests",
           "DEFAULT_ROOTS", "TEST_GLOB"]

#: zero-argument method calls that block without bound
_BLOCKING_ZERO_ARG = {
    "get": "queue.get() with no timeout",
    "join": "Thread.join() with no timeout",
    "result": "Future.result() with no timeout",
}

#: functions taking an optional timeout kwarg that blocks forever absent
_BLOCKING_NEEDS_TIMEOUT_KW = {"urlopen": "urlopen() with no timeout="}

_MUTATORS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "pop",
    "popleft", "popitem", "clear", "remove", "discard", "add", "update",
    "setdefault", "sort", "reverse",
})

_LOCKISH = re.compile(r"(lock|cond|mutex|sem)", re.IGNORECASE)
_SUPPRESS = re.compile(r"#\s*analysis:\s*ok(?:\(([A-Z0-9, -]+)\))?")

#: the source roots the gate lints, relative to the repo root
DEFAULT_ROOTS = ("deeplearning4j_tpu_torch", "chip_smoke.py")
#: the port's tests, which the gate lints too: a test thread still blocked
#: after its bounded join keeps a test worker from exiting
TEST_GLOB = "tests/test_torch_*.py"


def _dotted(node) -> Optional[str]:
    """``self.fleet._lock`` -> that string; None for non-name chains."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_self_attr(node, attrs: Dict[str, str]) -> Optional[str]:
    """The guarded attr name when ``node`` is ``self.<registered>``."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self" and node.attr in attrs):
        return node.attr
    return None


class _Ctx:
    """Lexical context threaded through the recursive statement walk."""

    __slots__ = ("symbol", "held", "self_locks", "guarded", "lock_attrs",
                 "assume_locked", "in_init")

    def __init__(self):
        self.symbol: List[str] = []
        self.held: List[str] = []        # dotted receivers of held locks
        self.self_locks: Set[str] = set()  # self.<attr> locks held
        self.guarded: Dict[str, str] = {}  # attr -> lock attr (class scope)
        self.lock_attrs: Set[str] = set()  # all lock attrs of the class
        self.assume_locked = False
        self.in_init = False

    @property
    def lock_held(self) -> bool:
        return bool(self.held) or self.assume_locked


class _Linter:
    def __init__(self, tree: ast.Module, src: str, path: str):
        self.tree = tree
        self.path = path
        self.lines = src.splitlines()
        self.findings: List[Finding] = []
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    # ------------------------------------------------------------- plumbing
    def _suppressed(self, node, code: str) -> bool:
        line = getattr(node, "lineno", 0)
        if not (1 <= line <= len(self.lines)):
            return False
        m = _SUPPRESS.search(self.lines[line - 1])
        if not m:
            return False
        which = m.group(1)
        return which is None or code.replace("DL4J-", "") in which \
            or code in which

    def _emit(self, code: str, node, ctx: _Ctx, message: str):
        if self._suppressed(node, code):
            return
        self.findings.append(Finding(
            code=code, path=self.path, line=getattr(node, "lineno", 0),
            symbol=".".join(ctx.symbol) or "<module>", message=message))

    # ----------------------------------------------------------- entry point
    def run(self) -> List[Finding]:
        ctx = _Ctx()
        for stmt in self.tree.body:
            self._stmt(stmt, ctx)
        return self.findings

    # ------------------------------------------------------------ statements
    def _stmt(self, node, ctx: _Ctx):
        if isinstance(node, ast.ClassDef):
            self._class(node, ctx)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._func(node, ctx)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            self._with(node, ctx)
        else:
            self._scan_exprs(node, ctx)
            self._check_writes(node, ctx)
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.stmt,)):
                    self._stmt(child, ctx)
                # compound statements keep their bodies as stmt lists —
                # iter_child_nodes yields them flattened, handled above

    def _class(self, node: ast.ClassDef, ctx: _Ctx):
        sub = _Ctx()
        sub.symbol = ctx.symbol + [node.name]
        sub.guarded = self._read_guarded(node)
        sub.lock_attrs = set(sub.guarded.values())
        for stmt in node.body:
            self._stmt(stmt, sub)

    def _func(self, node, ctx: _Ctx):
        sub = _Ctx()
        sub.symbol = ctx.symbol + [node.name]
        sub.guarded = ctx.guarded
        sub.lock_attrs = ctx.lock_attrs
        # nested helpers inherit the caller's held-lock convention; a
        # fresh thread-target closure does not hold its definer's `with`
        sub.assume_locked = (node.name.endswith("_locked")
                             or ctx.assume_locked)
        sub.in_init = node.name == "__init__" or ctx.in_init
        for stmt in node.body:
            self._stmt(stmt, sub)

    def _with(self, node, ctx: _Ctx):
        added_held, added_self = [], []
        for item in node.items:
            dn = _dotted(item.context_expr)
            if dn is None:
                continue
            leaf = dn.rsplit(".", 1)[-1]
            if _LOCKISH.search(leaf) or leaf in ctx.lock_attrs:
                added_held.append(dn)
                if dn.startswith("self.") and dn.count(".") == 1:
                    added_self.append(leaf)
            # the context expr itself may contain calls to scan
            self._scan_expr_tree(item.context_expr, ctx)
        ctx.held.extend(added_held)
        ctx.self_locks.update(added_self)
        for stmt in node.body:
            self._stmt(stmt, ctx)
        for _ in added_held:
            ctx.held.pop()
        ctx.self_locks.difference_update(added_self)

    # ---------------------------------------------------------- expressions
    def _scan_exprs(self, stmt, ctx: _Ctx):
        """Scan every expression directly inside one statement (without
        entering nested function/class bodies — those get their own
        context when visited as statements)."""
        for field, value in ast.iter_fields(stmt):
            vals = value if isinstance(value, list) else [value]
            for v in vals:
                if isinstance(v, ast.expr):
                    self._scan_expr_tree(v, ctx)

    def _scan_expr_tree(self, expr, ctx: _Ctx):
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._check_call(node, ctx)

    # ----------------------------------------------------------- call checks
    def _check_call(self, call: ast.Call, ctx: _Ctx):
        func = call.func
        # C001: bare acquire() outside with/try-finally
        if isinstance(func, ast.Attribute) and func.attr == "acquire":
            recv = _dotted(func.value)
            if recv is not None and not self._release_guaranteed(call, recv):
                self._emit("DL4J-C001", call, ctx,
                           f"{recv}.acquire() without try/finally release "
                           "(prefer `with`)")
        # C002/C003: untimed blocking calls
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None)
        if name in _BLOCKING_ZERO_ARG and not call.args \
                and not call.keywords:
            recv = (_dotted(func.value) or "<expr>") \
                if isinstance(func, ast.Attribute) else ""
            what = _BLOCKING_ZERO_ARG[name]
            if ctx.lock_held:
                self._emit("DL4J-C002", call, ctx,
                           f"{what} while holding "
                           f"{ctx.held[-1] if ctx.held else 'a lock'}")
            else:
                self._emit("DL4J-C003", call, ctx,
                           f"{what} on {recv or 'call result'}")
        if name in _BLOCKING_NEEDS_TIMEOUT_KW:
            if not any(kw.arg == "timeout" for kw in call.keywords) \
                    and len(call.args) < 3:
                code = "DL4J-C002" if ctx.lock_held else "DL4J-C003"
                self._emit(code, call, ctx, _BLOCKING_NEEDS_TIMEOUT_KW[name])
        # C004: non-daemon thread construction
        if name == "Thread":
            self._check_thread(call, ctx)
        # C005 via mutator call on a guarded attr
        if isinstance(func, ast.Attribute) and func.attr in _MUTATORS:
            attr = _is_self_attr(func.value, ctx.guarded)
            if attr is not None:
                self._check_guarded_write(call, ctx, attr,
                                          f".{func.attr}()")

    def _check_thread(self, call: ast.Call, ctx: _Ctx):
        for kw in call.keywords:
            if kw.arg == "daemon" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is True:
                return
        # accept a `<x>.daemon = True` anywhere in the enclosing function
        anc = call
        func_node = None
        while anc in self.parents:
            anc = self.parents[anc]
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                func_node = anc
                break
        if func_node is not None:
            for node in ast.walk(func_node):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) \
                                and t.attr == "daemon":
                            return
        self._emit("DL4J-C004", call, ctx,
                   "Thread() without daemon=True or a join-on-shutdown "
                   "daemon mark")

    def _release_guaranteed(self, call: ast.Call, recv: str) -> bool:
        """True when the acquire sits inside a Try whose finally releases
        the same receiver, or immediately precedes such a Try."""
        node = call
        stmt = None
        while node in self.parents:
            parent = self.parents[node]
            if isinstance(parent, ast.Try):
                if node in parent.body and self._releases(parent.finalbody,
                                                          recv):
                    return True
            if isinstance(node, ast.stmt) and stmt is None:
                stmt = node
            node = parent
        if stmt is None:
            return False
        parent = self.parents.get(stmt)
        body = getattr(parent, "body", None)
        if isinstance(body, list) and stmt in body:
            i = body.index(stmt)
            if i + 1 < len(body) and isinstance(body[i + 1], ast.Try):
                return self._releases(body[i + 1].finalbody, recv)
        return False

    def _releases(self, finalbody, recv: str) -> bool:
        for stmt in finalbody or ():
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "release" \
                        and _dotted(node.func.value) == recv:
                    return True
        return False

    # ---------------------------------------------------------- write checks
    def _check_writes(self, stmt, ctx: _Ctx):
        if not ctx.guarded:
            return
        targets = []
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                targets.extend(t.elts if isinstance(t, ast.Tuple) else [t])
        elif isinstance(stmt, ast.AugAssign):
            targets.append(stmt.target)
        elif isinstance(stmt, ast.Delete):
            targets.extend(stmt.targets)
        for t in targets:
            attr = _is_self_attr(t, ctx.guarded)
            if attr is not None:
                self._check_guarded_write(stmt, ctx, attr, "assignment")
                continue
            if isinstance(t, ast.Subscript):
                attr = _is_self_attr(t.value, ctx.guarded)
                if attr is not None:
                    self._check_guarded_write(stmt, ctx, attr, "item write")

    def _check_guarded_write(self, node, ctx: _Ctx, attr: str, how: str):
        lock = ctx.guarded[attr]
        if ctx.in_init or ctx.assume_locked or lock in ctx.self_locks:
            return
        self._emit("DL4J-C005", node, ctx,
                   f"write ({how}) to self.{attr} outside `with "
                   f"self.{lock}` (declared @guarded_by)")

    # -------------------------------------------------------- class registry
    @staticmethod
    def _read_guarded(node: ast.ClassDef) -> Dict[str, str]:
        reg: Dict[str, str] = {}
        for dec in node.decorator_list:
            if not isinstance(dec, ast.Call):
                continue
            fn = dec.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None)
            if name != "guarded_by":
                continue
            args = [a.value for a in dec.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str)]
            if len(args) >= 2:
                for a in args[1:]:
                    reg[a] = args[0]
        return reg


# -------------------------------------------------------------------------
# public entry points
# -------------------------------------------------------------------------

def lint_source(src: str, path: str) -> List[Finding]:
    """Lint one source string (``path`` is the repo-relative label)."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(code="DL4J-C000", path=path, line=e.lineno or 0,
                        symbol="<module>", message=f"syntax error: {e.msg}")]
    return _Linter(tree, src, path).run()


def lint_file(path: str, rel: Optional[str] = None) -> List[Finding]:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    return lint_source(src, rel or path)


def lint_tree(repo_root: str, roots=DEFAULT_ROOTS) -> List[Finding]:
    """Lint every ``.py`` file under the given roots (files or
    directories, repo-relative)."""
    findings: List[Finding] = []
    for root in roots:
        full = os.path.join(repo_root, root)
        if os.path.isfile(full):
            findings.extend(lint_file(full, root))
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                p = os.path.join(dirpath, fn)
                findings.extend(lint_file(p, os.path.relpath(p, repo_root)))
    return findings


def lint_tests(repo_root: str, pattern: str = TEST_GLOB) -> List[Finding]:
    """Lint every file matching ``pattern`` (repo-relative glob)."""
    findings: List[Finding] = []
    for p in sorted(glob.glob(os.path.join(repo_root, pattern))):
        findings.extend(lint_file(p, os.path.relpath(p, repo_root)))
    return findings
