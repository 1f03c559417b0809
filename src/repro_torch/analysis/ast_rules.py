"""Layer 1: AST rules over the port's source (``src/repro_torch``,
``examples/*_torch.py``, ``chip_smoke.py``): the port of
``repro.analysis.ast_rules``, each rule re-aimed at eager PyTorch.

The reference's five rules, and what became of each:

* ``pallas-literal-index`` — no counterpart: the port has no Pallas
  kernels (its kernels are CUDA C++, bound by ctypes), so there is no
  Pallas ref to index.
* ``host-sync-in-trace`` → ``host-sync-in-step``: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float``/``int``/``bool`` of
  one argument and ``torch.cuda.synchronize()`` inside step code each
  wait for the card once a step (and break CUDA graph capture).
* ``traced-python-branch`` → ``tensor-branch-in-step``: an ``if`` or
  ``while`` on a tensor's value inside step code reads it back to the
  host, a sync the step cannot be captured with.
* ``rng-key-reuse`` → ``global-rng``: a random draw (``rand*``,
  ``randn*``, ``randint``, ``randperm``, ``bernoulli``, ``multinomial``,
  ``normal``, ``normal_``, ``uniform_``, ``dropout``, …) without
  ``generator=`` takes the process's global stream; the port's rule is
  that every draw enters at an explicit seam (a generator, or a
  ``Draws``/``StepDraws`` the caller hands in). Anywhere, not only in step
  code.
* ``weak-scan-carry`` → ``implicit-dtype``: a floating factory call
  (``zeros``, ``ones``, ``full``, ``empty``, ``tensor``) in step code
  without ``dtype=`` takes the default dtype, which the caller may have
  changed: a state built so does not keep its dtype across steps.

**Step code** is the body of a function named ``step`` or ending in
``_step`` (``netes_step``, ``decode_step``, ``ShardedNetES._step``), and
every function defined inside a ``make_*_step`` or ``build_*_step``
builder (the closures the entry points build). Every rule is heuristic
— precision is favored over recall — and intentional violations carry
inline ``# repro: allow[rule] -- why`` justifications.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

from .findings import Finding, apply_suppressions

# --------------------------------------------------------------------------
# shared AST helpers
# --------------------------------------------------------------------------


def dotted(node: ast.AST) -> Optional[str]:
    """Render ``torch.cuda.synchronize``-style attribute chains; None
    otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_step_name(name: str) -> bool:
    return name == "step" or name.endswith("_step")


def _is_builder(name: str) -> bool:
    return (name.startswith("make_") or name.startswith("build_")) \
        and name.endswith("_step")


def collect_step_functions(tree: ast.AST) -> List[ast.FunctionDef]:
    """Step code: defs named ``step`` / ``*_step`` (builders excepted)
    and every def nested in a ``make_*_step`` / ``build_*_step``
    builder. Nested defs inside a step are walked as part of it."""
    out: List[ast.FunctionDef] = []

    def visit(node: ast.AST, in_builder: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _is_builder(child.name):
                    visit(child, True)
                elif in_builder or _is_step_name(child.name):
                    out.append(child)
                else:
                    visit(child, in_builder)
            else:
                visit(child, in_builder)

    visit(tree, False)
    return out


def _param_names(fn: ast.FunctionDef) -> List[str]:
    a = fn.args
    names = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    return names


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


# --------------------------------------------------------------------------
# rule framework
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    tier: str          # "standard" runs always; "strict" only under --strict
    hint: str
    doc: str

    def check(self, tree: ast.AST, src: str, path: str) -> List[Finding]:
        raise NotImplementedError

    def finding(self, path: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule=self.id, path=path,
                       line=getattr(node, "lineno", 0),
                       message=message, hint=self.hint)


class HostSyncInStep(Rule):
    """Flag host-synchronizing calls inside step code: ``float()`` /
    ``int()`` / ``bool()`` of one argument, ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()`` and ``torch.cuda.synchronize()``."""

    def check(self, tree, src, path):
        out: List[Finding] = []
        seen: Set[int] = set()
        for fn in collect_step_functions(tree):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                seen.add(id(node))
                msg = self._classify(node)
                if msg:
                    out.append(self.finding(path, node, msg))
        return out

    def _classify(self, call: ast.Call) -> Optional[str]:
        f = call.func
        if (isinstance(f, ast.Name) and f.id in ("float", "int", "bool")
                and len(call.args) == 1 and not call.keywords
                and not isinstance(call.args[0], ast.Constant)):
            return (f"builtin {f.id}() inside step code reads its argument "
                    f"on the host (a sync with the card per step)")
        if isinstance(f, ast.Attribute):
            if f.attr in ("item", "tolist", "cpu", "numpy") \
                    and not call.args:
                return (f".{f.attr}() inside step code copies to the host "
                        f"and waits for the card, once a step")
            if dotted(f) == "torch.cuda.synchronize":
                return "torch.cuda.synchronize() inside step code"
        return None


_TENSOR_READS = {"any", "all", "item", "equal", "allclose", "isfinite",
                 "isnan", "sum", "max", "min", "mean", "norm"}
_SHAPE_CALLS = {"isinstance", "callable", "hasattr", "len", "getattr"}


class TensorBranchInStep(Rule):
    """Flag ``if`` / ``while`` tests in step code that read a tensor:
    a ``torch.*`` call, a tensor reduction method (``.any()``,
    ``.sum()``, …) or a bare parameter of the step. ``is`` / ``is not``
    comparisons, ``isinstance`` / ``len`` / ``hasattr`` tests and
    ``.shape`` / ``.dim()`` / ``.dtype`` / ``.device`` reads are exempt
    (they are host values)."""

    def check(self, tree, src, path):
        out: List[Finding] = []
        seen: Set[int] = set()
        for fn in collect_step_functions(tree):
            params = set(_param_names(fn)) - {"self", "cls"}
            for node in ast.walk(fn):
                if not isinstance(node, (ast.If, ast.While)) \
                        or id(node) in seen:
                    continue
                seen.add(id(node))
                what = self._reads_tensor(node.test, params)
                if what:
                    out.append(self.finding(
                        path, node,
                        f"Python branch on a tensor value ({what}) in "
                        f"step code: the test reads it back to the host"))
        return out

    def _reads_tensor(self, test: ast.AST, params: Set[str]) -> Optional[str]:
        skip: Set[int] = set()
        for node in ast.walk(test):
            if isinstance(node, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                skip.update(id(s) for s in ast.walk(node))
            if isinstance(node, ast.Call):
                d = dotted(node.func)
                if d in _SHAPE_CALLS:
                    skip.update(id(s) for s in ast.walk(node))
            if isinstance(node, ast.Attribute) and node.attr in (
                    "shape", "dtype", "device", "ndim", "is_cuda"):
                skip.update(id(s) for s in ast.walk(node))
            elif isinstance(node, ast.Attribute):
                # a field of a parameter (``cfg.learned_pos``) is not the
                # parameter's tensor value
                skip.add(id(node.value))
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and node.func.attr in (
                    "dim", "size", "numel", "get", "is_floating_point"):
                skip.update(id(s) for s in ast.walk(node))
        for node in ast.walk(test):
            if id(node) in skip:
                continue
            if isinstance(node, ast.Call):
                d = dotted(node.func) or ""
                if d.startswith("torch."):
                    return f"{d}()"
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _TENSOR_READS:
                    return f".{node.func.attr}()"
            if isinstance(node, ast.Name) and node.id in params \
                    and isinstance(node.ctx, ast.Load):
                return f"parameter {node.id!r}"
        return None


_RNG_FUNCS = {"rand", "randn", "randint", "randperm", "rand_like",
              "randn_like", "randint_like", "bernoulli", "multinomial",
              "normal", "poisson"}
_RNG_METHODS = {"normal_", "uniform_", "bernoulli_", "exponential_",
                "random_", "geometric_", "log_normal_", "cauchy_"}
_DROPOUT = {"dropout", "dropout_", "alpha_dropout", "feature_dropout"}


class GlobalRng(Rule):
    """Flag random draws from the process's global generator: a
    ``torch.rand*``-style call or a ``.normal_()``-style method without
    ``generator=``, and every ``dropout`` call (it takes no generator)."""

    def check(self, tree, src, path):
        out: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            leaf = d.split(".")[-1] if d else (
                node.func.attr if isinstance(node.func, ast.Attribute)
                else None)
            if leaf is None:
                continue
            root = d.split(".")[0] if d else None
            if leaf in _DROPOUT and root in ("torch", "F", "nn",
                                             "functional"):
                out.append(self.finding(
                    path, node, f"{d}() draws its mask from the global "
                                f"generator (it takes none)"))
            elif leaf in _RNG_FUNCS and root == "torch" \
                    and not _has_kw(node, "generator"):
                out.append(self.finding(
                    path, node, f"{d}() without generator= draws from the "
                                f"global stream"))
            elif leaf in _RNG_METHODS and isinstance(node.func,
                                                     ast.Attribute) \
                    and not _has_kw(node, "generator"):
                out.append(self.finding(
                    path, node, f".{leaf}() without generator= draws from "
                                f"the global stream"))
        return out


_FACTORIES = {"zeros", "ones", "full", "empty", "tensor"}


class ImplicitDtype(Rule):
    """Flag ``torch.zeros`` / ``ones`` / ``full`` / ``empty`` / ``tensor``
    in step code without ``dtype=`` (``*_like`` and ``new_*`` take their
    dtype from a tensor and pass)."""

    def check(self, tree, src, path):
        out: List[Finding] = []
        seen: Set[int] = set()
        for fn in collect_step_functions(tree):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                seen.add(id(node))
                d = dotted(node.func)
                if d is None or not d.startswith("torch."):
                    continue
                leaf = d.split(".")[-1]
                if leaf in _FACTORIES and d.count(".") == 1 \
                        and not _has_kw(node, "dtype"):
                    out.append(self.finding(
                        path, node,
                        f"{d}() in step code without dtype= takes the "
                        f"default dtype, not the state's"))
        return out


RULES: Dict[str, Rule] = {r.id: r for r in (
    HostSyncInStep(
        id="host-sync-in-step", tier="standard",
        hint="keep per-step values on the device and drain them with "
             "obs.cuda_watch.device_get outside the step; suppress with "
             "a justification if the operand is a host value",
        doc="host sync inside step code"),
    TensorBranchInStep(
        id="tensor-branch-in-step", tier="standard",
        hint="select with torch.where, or branch on a host value "
             "(a config field, a shape)",
        doc="Python branch on a tensor value inside step code"),
    GlobalRng(
        id="global-rng", tier="standard",
        hint="pass generator= (a torch.Generator seeded at the draw's "
             "seam), or take the draw from the caller's Draws",
        doc="random draw from the global generator"),
    ImplicitDtype(
        id="implicit-dtype", tier="standard",
        hint="give the factory an explicit dtype= (the state's, or "
             "torch.float32)",
        doc="floating factory call in step code without dtype="),
)}


def run_rules(paths: Iterable[Path], rules: Optional[Sequence[str]] = None,
              strict: bool = False) -> List[Finding]:
    """Run the selected AST rules over every ``.py`` file under
    ``paths`` (files or directories), returning suppression-resolved
    findings sorted by location."""
    selected = [RULES[r] for r in rules] if rules else [
        r for r in RULES.values() if strict or r.tier == "standard"]
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        else:
            files.append(p)
    out: List[Finding] = []
    for f in files:
        src = f.read_text()
        try:
            tree = ast.parse(src, filename=str(f))
        except SyntaxError as e:
            out.append(Finding(rule="syntax-error", path=str(f),
                               line=e.lineno or 0, message=str(e.msg)))
            continue
        per_file: List[Finding] = []
        for rule in selected:
            per_file.extend(rule.check(tree, src, str(f)))
        out.extend(apply_suppressions(per_file, src, str(f)))
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out
