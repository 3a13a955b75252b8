"""AST-level determinism rules (DET001/DET002/DET003) for kernel-math
sources.

These run on source text — no imports, no tracing — so they can vet a
module (including a third-party operator plugin) before it is ever
loaded. Scope is deliberately the kernel-math tree (``repro_torch/core``,
``repro_torch/kernels``): serving, the tuner, the build and the chaos
runtime are *supposed* to read clocks and draw seeds.

- DET001: no wall-clock or randomness sources. Importing ``time`` /
  ``random`` / ``secrets`` / ``uuid`` at all, or calling
  ``numpy.random.*`` / ``datetime.now`` / ``os.urandom``, makes retraces
  non-reproducible and poisons jit cache keys.
- DET002: no Python ``if`` / ``while`` / ``assert`` / ``bool()`` on a
  ``torch`` expression — for a tensor on the card that reads a value back
  to the host: a device→host sync that stalls the stream behind it.
  Static shape, dtype and device queries (``torch.is_floating_point``,
  ``torch.cuda.is_available``, ...) and static NumPy (``np.*``) in branch
  tests are fine: taps are host constants.
- DET003 (AST half): every ``register_static`` target must be a frozen
  dataclass. An unfrozen dataclass defines ``__eq__`` and therefore
  loses ``__hash__``; the port registers nothing with JAX, but the form
  stays so that a source scans the same in both packages. The port's own
  cache-key classes are checked at run time
  (``rules.check_static_registration``).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.violations import Violation

__all__ = ["scan_source", "scan_file"]

# Modules whose mere import into kernel math is a DET001 violation.
_BANNED_MODULES = {"time", "random", "secrets", "uuid"}

# Dotted call prefixes that are nondeterminism sources even when the
# root module is otherwise legitimate.
_BANNED_CALL_PREFIXES = (
    "time.",
    "random.",
    "secrets.",
    "uuid.",
    "numpy.random.",
    "os.urandom",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
    "datetime.date.today",
)

_TENSOR_MODULES = {"torch"}

# torch calls that are static shape/dtype/device queries, not tensor math —
# branching on these reads nothing back from the device.
_STATIC_TORCH_FUNCS = {
    "is_tensor",
    "is_floating_point",
    "is_complex",
    "numel",
    "device",
    "dtype",
    "finfo",
    "iinfo",
    "result_type",
    "promote_types",
    "can_cast",
    "get_default_dtype",
    "is_grad_enabled",
    "is_available",
    "device_count",
    "current_device",
    "get_device_name",
    "get_device_properties",
}


class _Aliases(ast.NodeVisitor):
    """alias -> canonical dotted module name, from import statements."""

    def __init__(self) -> None:
        self.modules: Dict[str, str] = {}

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.modules[a.asname or a.name.split(".")[0]] = a.name

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module is None or node.level:
            return
        for a in node.names:
            self.modules[a.asname or a.name] = f"{node.module}.{a.name}"


def _dotted(node: ast.AST, modules: Dict[str, str]) -> Optional[str]:
    """Canonical dotted name of an attribute/name chain, with the root
    resolved through the module's import aliases."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    root = modules.get(cur.id, cur.id)
    parts.append(root)
    return ".".join(reversed(parts))


def _contains_tensor_call(node: ast.AST, modules: Dict[str, str]) -> Optional[str]:
    """First torch call inside ``node`` that computes on tensors, as its
    dotted name."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            name = _dotted(sub.func, modules)
            if (
                name
                and any(name == m or name.startswith(m + ".") for m in _TENSOR_MODULES)
                and name.rsplit(".", 1)[-1] not in _STATIC_TORCH_FUNCS
            ):
                return name
    return None


def scan_source(
    source: str,
    path: str,
    *,
    rules: Sequence[str] = ("DET001", "DET002", "DET003"),
) -> List[Violation]:
    """Run the determinism rules over one module's source text."""
    tree = ast.parse(source, filename=path)
    aliases = _Aliases()
    aliases.visit(tree)
    modules = aliases.modules
    out: List[Violation] = []

    def loc(node: ast.AST) -> str:
        return f"{path}:{node.lineno}"

    if "DET001" in rules:
        for node in ast.walk(tree):
            names: List[str] = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for name in names:
                if name.split(".")[0] in _BANNED_MODULES:
                    out.append(
                        Violation(
                            "DET001",
                            loc(node),
                            f"kernel-math module imports `{name}` "
                            "(wall-clock/randomness source)",
                            detail=(("module", name),),
                        )
                    )
            if isinstance(node, ast.Call):
                name = _dotted(node.func, modules)
                if name and any(
                    name == p.rstrip(".") or name.startswith(p)
                    for p in _BANNED_CALL_PREFIXES
                ):
                    out.append(
                        Violation(
                            "DET001",
                            loc(node),
                            f"nondeterministic call `{name}` in kernel math",
                            detail=(("call", name),),
                        )
                    )

    if "DET002" in rules:
        for node in ast.walk(tree):
            test: Optional[ast.AST] = None
            kind = ""
            if isinstance(node, (ast.If, ast.While)):
                test, kind = node.test, type(node).__name__.lower()
            elif isinstance(node, ast.Assert):
                test, kind = node.test, "assert"
            elif isinstance(node, ast.IfExp):
                test, kind = node.test, "conditional expression"
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "bool"
                and node.args
            ):
                test, kind = node.args[0], "bool()"
            if test is None:
                continue
            hit = _contains_tensor_call(test, modules)
            if hit:
                out.append(
                    Violation(
                        "DET002",
                        loc(node),
                        f"Python {kind} branches on `{hit}(...)` — a tensor "
                        "value read back to the host; use torch.where or hoist "
                        "to static config",
                        detail=(("call", hit), ("kind", kind)),
                    )
                )

    if "DET003" in rules:
        frozen: Dict[str, bool] = {}
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            is_dc = False
            is_frozen = False
            for dec in node.decorator_list:
                name = _dotted(dec.func if isinstance(dec, ast.Call) else dec, modules)
                if name is None or not name.split(".")[-1] == "dataclass":
                    continue
                is_dc = True
                if isinstance(dec, ast.Call):
                    for kw in dec.keywords:
                        if kw.arg == "frozen" and isinstance(kw.value, ast.Constant):
                            is_frozen = bool(kw.value.value)
            if is_dc:
                frozen[node.name] = is_frozen
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func, modules)
            if name is None or not name.endswith("register_static"):
                continue
            for arg in node.args:
                if isinstance(arg, ast.Name) and arg.id in frozen and not frozen[arg.id]:
                    out.append(
                        Violation(
                            "DET003",
                            loc(node),
                            f"`{arg.id}` is registered static but its "
                            "dataclass is not frozen=True (unfrozen "
                            "dataclasses are unhashable)",
                            detail=(("class", arg.id),),
                        )
                    )
    return out


def scan_file(
    path: str,
    *,
    rel: Optional[str] = None,
    rules: Sequence[str] = ("DET001", "DET002", "DET003"),
) -> List[Violation]:
    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    return scan_source(source, rel or path, rules=rules)
