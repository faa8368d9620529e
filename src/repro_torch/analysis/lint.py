"""Pass 3 — the port's lint rule engine (AST-based, named per-path rules);
the twin of ``src/repro/analysis/lint.py``.

The offload seam only stays transparent if every layer goes through it:
the model zoo must not hand-roll GEMMs or bare engine accounting, a
kernel library loads only inside the function that launches it, the
frontend and this package must not load the engine at import, the
registry must stay closed, and every trace record must carry its
placement.  Each invariant is a named :class:`LintRule` reported as
``path:line: rule: message`` (``tools/repro_torch_lint.py`` drives it).

Rules, each with the reference rule it stands for:

* ``models-no-raw-matmul`` (``models-no-dot-general``) — no
  ``torch.matmul`` / ``torch.mm`` / ``torch.bmm`` and no ``@`` under
  ``models/``: every GEMM goes through ``core/blas.py``, so the records
  and the kernels see it;
* ``models-no-bare-launch`` — no ``engine().launch(...)`` under
  ``models/`` (accounting the scheduler/cost model/trace cannot see);
* ``kernel-load-in-launchers`` (``no-jax-probe-outside-compat``: the
  reference's seam to its backend) — no module-scope ``triton`` import and
  no module-scope library load (``ctypes.CDLL`` / ``LoadLibrary``,
  ``torch.ops.load_library``, ``_build.library`` / ``build_all``): a
  kernel is built and loaded inside the call that launches it, so the
  port imports on a machine with no card;
* ``frontend-import-light`` — no module-scope import of the engine
  (``repro_torch.core``, ``.kernels``, ``.models``, ``.launch``) under
  ``frontend/`` and ``analysis/``: they load it at first use;
* ``trace-record-device-id`` — every ``OffloadRecord``/``LaunchTicket``
  constructor names its ``device_id``;
* ``registry-closure`` — repo-level: every ``_lowering("x")`` fetch in
  ``core/blas.py`` has a ``kernels/ops.py::KERNEL_LOWERINGS`` row, every
  row of the reference's ``PALLAS_LOWERINGS`` has one too, and the port
  registers exactly the reference's ops (read from its source, never
  imported; the reference's third home, its parity-sample dict, has no
  twin: the port's parity suites are per module);
* ``serve-no-wallclock`` — no ``time.time``/``perf_counter``/``datetime
  .now`` reads in the streaming-serve cost paths (``launch/streaming.py``,
  ``launch/costing.py``);
* ``obs-modeled-time-only`` — the same over the observability layer
  (``obs/``) and its instrumentation call sites (``core/hero.py``,
  ``core/dispatch.py``, ``frontend/schedule.py``).

Import-light by contract: stdlib only at module scope.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Callable, List, Optional, Sequence, Set

from repro_torch.analysis.base import Violation

__all__ = [
    "FileView",
    "LintRule",
    "RULES",
    "check_registry_closure",
    "lint_file",
    "repo_root",
    "run_lint",
]

PORT = "src/repro_torch/"


def repo_root() -> pathlib.Path:
    """Repo root: nearest ancestor of this file holding ``src/repro_torch``."""
    for parent in pathlib.Path(__file__).resolve().parents:
        if (parent / "src" / "repro_torch").is_dir():
            return parent
    return pathlib.Path.cwd()


@dataclasses.dataclass
class FileView:
    """One parsed source file as the rules see it."""

    path: pathlib.Path
    rel: str                      # posix path relative to the repo root
    source: str
    tree: Optional[ast.AST]       # None when the file failed to parse

    @classmethod
    def load(cls, path: pathlib.Path, root: pathlib.Path) -> "FileView":
        source = path.read_text()
        try:
            rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = path.as_posix()
        try:
            tree = ast.parse(source)
        except SyntaxError:
            tree = None
        return cls(path=path, rel=rel, source=source, tree=tree)

    def where(self, node: ast.AST) -> str:
        return f"{self.rel}:{getattr(node, 'lineno', 0)}"


@dataclasses.dataclass(frozen=True)
class LintRule:
    """One named invariant: where it applies, and how to check one file."""

    name: str
    description: str
    paths: tuple                  # rel-path prefixes the rule applies under
    check: Callable[["FileView"], List[Violation]]

    def applies(self, rel: str) -> bool:
        return rel.endswith(".py") and any(rel.startswith(p)
                                           for p in self.paths)


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------

def _root_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` of a Name/Attribute chain ('' for anything else)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))


def _is_type_checking_if(node: ast.If) -> bool:
    t = node.test
    return (isinstance(t, ast.Name) and t.id == "TYPE_CHECKING") or (
        isinstance(t, ast.Attribute) and t.attr == "TYPE_CHECKING"
    )


def _module_scope_stmts(tree: ast.AST):
    """Statements that execute at import time: the module body, recursing
    into class bodies and if/try arms, never into function bodies; a
    ``TYPE_CHECKING`` guard is exempt (it never runs at import)."""
    stack = list(getattr(tree, "body", []))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, ast.If):
            if not _is_type_checking_if(node):
                stack.extend(node.body)
            stack.extend(node.orelse)
        elif isinstance(node, ast.ClassDef):
            stack.extend(node.body)
        elif isinstance(node, ast.Try):
            stack.extend(node.body)
            for h in node.handlers:
                stack.extend(h.body)
            stack.extend(node.orelse)
            stack.extend(node.finalbody)


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


def _import_time_calls(stmt: ast.AST):
    """Calls a module-scope statement makes at import: its expressions,
    and a definition's decorators and defaults, never a body that runs
    later (a nested class body is yielded as a statement of its own)."""
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
        roots = list(stmt.decorator_list) + list(stmt.args.defaults) + [
            d for d in stmt.args.kw_defaults if d is not None]
    elif isinstance(stmt, ast.ClassDef):
        roots = list(stmt.decorator_list) + list(stmt.bases)
    elif isinstance(stmt, (ast.If, ast.Try)):
        roots = [stmt.test] if isinstance(stmt, ast.If) else []
    else:
        roots = [stmt]
    stack = roots
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Call):
            yield node
        stack.extend(c for c in ast.iter_child_nodes(node)
                     if not isinstance(c, _SCOPES))


def _module_imports(tree: ast.AST):
    """(node, module name) of every module-scope import; ``from a import
    b`` gives both ``a`` and ``a.b`` (``b`` may be a submodule)."""
    for node in _module_scope_stmts(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mod = node.module or ""
            yield node, mod
            for a in node.names:
                yield node, f"{mod}.{a.name}"


def _under(name: str, packages: Sequence[str]) -> bool:
    return any(name == p or name.startswith(p + ".") for p in packages)


# ---------------------------------------------------------------------------
# Per-file rule checks
# ---------------------------------------------------------------------------

_RAW_GEMM_CALLS = frozenset({"matmul", "mm", "bmm"})


def _check_no_raw_matmul(view: FileView) -> List[Violation]:
    out = []
    for node in ast.walk(view.tree):
        what = None
        if isinstance(node, (ast.BinOp, ast.AugAssign)) and isinstance(
                node.op, ast.MatMult):
            what = "@"
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr in _RAW_GEMM_CALLS
              and _dotted(node.func.value) == "torch"):
            what = f"torch.{node.func.attr}"
        if what:
            out.append(Violation(
                "models-no-raw-matmul",
                f"raw GEMM ({what}) under models/ — dispatch through a "
                "registered OffloadOp (core/blas.py) so the records, the "
                "kernels and the plans see the call",
                view.where(node),
            ))
    return out


def _check_no_bare_launch(view: FileView) -> List[Violation]:
    out = []
    for node in ast.walk(view.tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        fn = node.func
        if (
            fn.attr == "launch"
            and isinstance(fn.value, ast.Call)
            and isinstance(fn.value.func, ast.Name)
            and fn.value.func.id in ("engine", "_engine")
        ):
            out.append(Violation(
                "models-no-bare-launch",
                "bare engine().launch(...) under models/ — go through "
                "dispatch()/dispatch_placed() so placement and accounting "
                "stay on the registry path",
                view.where(node),
            ))
    return out


_LIBRARY_LOADS = frozenset({
    "CDLL", "PyDLL", "LoadLibrary", "load_library", "library", "build_all",
})


def _check_kernel_load(view: FileView) -> List[Violation]:
    out = []
    for node, name in _module_imports(view.tree):
        if _under(name, ("triton",)):
            out.append(Violation(
                "kernel-load-in-launchers",
                f"module-scope import of {name} — triton loads inside the "
                "function that launches its kernel, so the port imports "
                "with no card and no triton",
                view.where(node),
            ))
    for stmt in _module_scope_stmts(view.tree):
        for call in _import_time_calls(stmt):
            fn = call.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None)
            if name in _LIBRARY_LOADS:
                out.append(Violation(
                    "kernel-load-in-launchers",
                    f"module-scope kernel library load ({_dotted(fn) or name}"
                    "(...)) — a kernel is built and loaded inside the call "
                    "that launches it (kernels/_build.py), never at import",
                    view.where(call),
                ))
    return out


_ENGINE = ("repro_torch.core", "repro_torch.kernels", "repro_torch.models",
           "repro_torch.launch")


def _check_import_light(view: FileView) -> List[Violation]:
    out = []
    seen = set()
    for node, name in _module_imports(view.tree):
        if _under(name, _ENGINE) and id(node) not in seen:
            seen.add(id(node))
            out.append(Violation(
                "frontend-import-light",
                f"module-scope import of {name} — frontend/analysis modules "
                "are import-light by contract (the engine loads lazily at "
                "first use)",
                view.where(node),
            ))
    return out


_WALLCLOCK_CALLS = frozenset({
    "time", "time_ns", "perf_counter", "perf_counter_ns",
    "monotonic", "monotonic_ns", "process_time", "process_time_ns",
})


def _time_aliases(tree: ast.AST) -> Set[str]:
    """Names bound to the ``time`` module (or its clock functions)."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time" or a.name.startswith("time."):
                    names.add(a.asname or "time")
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "") == "time":
                for a in node.names:
                    names.add(a.asname or a.name)
    return names


def _no_wallclock_check(rule: str, context: str):
    """A wallclock checker for one rule: the modeled-time contract (two
    same-seed runs must be byte-identical) is shared by the streaming-serve
    cost paths (``serve-no-wallclock``) and the observability /
    instrumentation seams (``obs-modeled-time-only``).  Flag the imports
    (any wall clock enters through them) and every clock-function call."""

    def check(view: FileView) -> List[Violation]:
        out = []
        aliases = _time_aliases(view.tree)
        for node in ast.walk(view.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "time" or a.name.startswith("time."):
                        out.append(Violation(
                            rule,
                            f"import of the time module in {context} — "
                            "the serve path is modeled-time only (seeded "
                            "traces + LaunchTicket event clocks); a "
                            "wall-clock read breaks same-seed determinism",
                            view.where(node),
                        ))
            elif isinstance(node, ast.ImportFrom):
                if (node.module or "") == "time":
                    out.append(Violation(
                        rule,
                        "from time import "
                        f"{', '.join(a.name for a in node.names)}"
                        f" in {context} — modeled time only",
                        view.where(node),
                    ))
            elif isinstance(node, ast.Call):
                fn = node.func
                name = None
                if (
                    isinstance(fn, ast.Attribute)
                    and fn.attr in _WALLCLOCK_CALLS
                    and _root_name(fn) in aliases
                ):
                    name = f"{_root_name(fn)}.{fn.attr}"
                elif isinstance(fn, ast.Name) and fn.id in aliases \
                        and fn.id in _WALLCLOCK_CALLS:
                    name = fn.id
                elif (
                    isinstance(fn, ast.Attribute)
                    and fn.attr in ("now", "utcnow", "today")
                    and _root_name(fn) in ("datetime", "date")
                ):
                    name = f"{_root_name(fn)}.{fn.attr}"
                if name:
                    out.append(Violation(
                        rule,
                        f"{name}() wall-clock read in {context} — "
                        "timestamps come from modeled LaunchTicket "
                        "events, never the host clock",
                        view.where(node),
                    ))
        return out

    return check


_check_no_wallclock = _no_wallclock_check(
    "serve-no-wallclock", "a streaming-serve cost path")
_check_obs_modeled_time = _no_wallclock_check(
    "obs-modeled-time-only", "an observability/instrumentation path")


_TRACE_RECORDS = ("OffloadRecord", "LaunchTicket")


def _check_trace_device_id(view: FileView) -> List[Violation]:
    out = []
    for node in ast.walk(view.tree):
        if not isinstance(node, ast.Call):
            continue
        name = (
            node.func.id if isinstance(node.func, ast.Name)
            else node.func.attr if isinstance(node.func, ast.Attribute)
            else None
        )
        if name not in _TRACE_RECORDS:
            continue
        kw = {k.arg for k in node.keywords}
        if "device_id" not in kw and None not in kw:  # None == **kwargs
            out.append(Violation(
                "trace-record-device-id",
                f"{name}(...) without device_id= — every trace record "
                "carries the placement it ran on; defaulting it hides "
                "mis-placed launches from the per-device rollups",
                view.where(node),
            ))
    return out


# ---------------------------------------------------------------------------
# Repo-level rule: registry closure
# ---------------------------------------------------------------------------

def _registered_names(blas_tree: ast.AST) -> List[str]:
    """Names of ``register(OffloadOp(name="...", ...))`` sites."""
    names = []
    for node in ast.walk(blas_tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "OffloadOp"
        ):
            continue
        for k in node.keywords:
            if k.arg == "name" and isinstance(k.value, ast.Constant):
                names.append(k.value.value)
    return names


def _fetches(blas_tree: ast.AST, fetcher: str) -> List[tuple]:
    """``(name, lineno)`` for every literal ``fetcher("x")`` call."""
    fetches = []
    for node in ast.walk(blas_tree):
        fn = getattr(node, "func", None)
        if (
            isinstance(node, ast.Call)
            and ((isinstance(fn, ast.Name) and fn.id == fetcher)
                 or (isinstance(fn, ast.Attribute) and fn.attr == fetcher))
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            fetches.append((node.args[0].value, node.lineno))
    return fetches


def _table_keys(tree: ast.AST, name: str) -> List[str]:
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == name
                    for t in node.targets)
            and isinstance(node.value, ast.Dict)
        ):
            return [k.value for k in node.value.keys
                    if isinstance(k, ast.Constant) and isinstance(k.value, str)]
    return []


def check_registry_closure(root: Optional[pathlib.Path] = None) -> List[Violation]:
    """Static closure of the op registry across its homes: the port's
    ``core/blas.py`` (descriptors + ``_lowering`` fetches) and
    ``kernels/ops.py`` (``KERNEL_LOWERINGS``), against the reference's
    ``core/blas.py`` and ``kernels/ops.py`` (read, never imported)."""
    root = root or repo_root()
    blas = root / "src" / "repro_torch" / "core" / "blas.py"
    ops = root / "src" / "repro_torch" / "kernels" / "ops.py"
    ref_blas = root / "src" / "repro" / "core" / "blas.py"
    ref_ops = root / "src" / "repro" / "kernels" / "ops.py"
    homes = (blas, ops, ref_blas, ref_ops)
    missing = [p for p in homes if not p.is_file()]
    if missing:
        return [Violation(
            "registry-closure",
            f"cannot check: missing {[str(m) for m in missing]}",
        )]
    blas_tree, ops_tree, ref_blas_tree, ref_ops_tree = (
        ast.parse(p.read_text()) for p in homes)
    table = _table_keys(ops_tree, "KERNEL_LOWERINGS")
    rel = blas.relative_to(root).as_posix()
    ops_rel = ops.relative_to(root).as_posix()
    out: List[Violation] = []
    for name, lineno in _fetches(blas_tree, "_lowering"):
        if name not in table:
            out.append(Violation(
                "registry-closure",
                f"_lowering({name!r}) has no KERNEL_LOWERINGS row in "
                "kernels/ops.py — the fetch would KeyError at first kernel "
                "dispatch",
                f"{rel}:{lineno}",
            ))
    for name in _table_keys(ref_ops_tree, "PALLAS_LOWERINGS"):
        if name not in table:
            out.append(Violation(
                "registry-closure",
                f"the reference's PALLAS_LOWERINGS row {name!r} has no "
                "KERNEL_LOWERINGS row — a TPU kernel the port does not "
                "lower",
                ops_rel,
            ))
    registered = _registered_names(blas_tree)
    ref_registered = _registered_names(ref_blas_tree)
    for name in registered:
        if name not in ref_registered:
            out.append(Violation(
                "registry-closure",
                f"registered op {name!r} has no twin in the reference's "
                "core/blas.py — the parity suites cannot hold it",
                rel,
            ))
    for name in ref_registered:
        if name not in registered:
            out.append(Violation(
                "registry-closure",
                f"the reference registers {name!r} and the port does not "
                "— an op the port's hnp and dispatch lack",
                rel,
            ))
    return out


# ---------------------------------------------------------------------------
# The rule table + engine
# ---------------------------------------------------------------------------

RULES = (
    LintRule(
        name="models-no-raw-matmul",
        description="no torch.matmul/mm/bmm or @ under models/",
        paths=(PORT + "models/",),
        check=_check_no_raw_matmul,
    ),
    LintRule(
        name="models-no-bare-launch",
        description="no bare engine().launch(...) under models/",
        paths=(PORT + "models/",),
        check=_check_no_bare_launch,
    ),
    LintRule(
        name="kernel-load-in-launchers",
        description="no module-scope triton import or kernel library load",
        paths=(PORT,),
        check=_check_kernel_load,
    ),
    LintRule(
        name="frontend-import-light",
        description="no module-scope engine imports under frontend/ and "
                    "analysis/",
        paths=(PORT + "frontend/", PORT + "analysis/"),
        check=_check_import_light,
    ),
    LintRule(
        name="trace-record-device-id",
        description="OffloadRecord/LaunchTicket constructors carry device_id",
        paths=(PORT,),
        check=_check_trace_device_id,
    ),
    LintRule(
        name="serve-no-wallclock",
        description="no wall-clock reads in the streaming-serve cost paths",
        paths=(
            PORT + "launch/streaming.py",
            PORT + "launch/costing.py",
        ),
        check=_check_no_wallclock,
    ),
    LintRule(
        name="obs-modeled-time-only",
        description="spans/metrics take timestamps from modeled clocks, "
                    "never time.* or datetime",
        paths=(
            PORT + "obs/",
            PORT + "core/hero.py",
            PORT + "core/dispatch.py",
            PORT + "frontend/schedule.py",
        ),
        check=_check_obs_modeled_time,
    ),
)


def lint_file(
    path: pathlib.Path,
    root: Optional[pathlib.Path] = None,
    rules: Optional[Sequence[LintRule]] = None,
) -> List[Violation]:
    root = root or repo_root()
    view = FileView.load(pathlib.Path(path), root)
    if view.tree is None:
        return [Violation("parse-error", "file does not parse", view.rel)]
    out: List[Violation] = []
    for rule in (RULES if rules is None else rules):
        if rule.applies(view.rel):
            out.extend(rule.check(view))
    return out


def run_lint(
    root: Optional[pathlib.Path] = None,
    paths: Optional[Sequence[pathlib.Path]] = None,
    rules: Optional[Sequence[LintRule]] = None,
    *,
    repo_rules: bool = True,
) -> List[Violation]:
    """Lint every ``.py`` under ``paths`` (default: ``src/repro_torch``)
    with the per-file rules, plus the repo-level registry-closure rule."""
    root = root or repo_root()
    if paths is None:
        paths = [root / "src" / "repro_torch"]
    out: List[Violation] = []
    for p in paths:
        p = pathlib.Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            out.extend(lint_file(f, root, rules))
    if repo_rules:
        out.extend(check_registry_closure(root))
    return out
