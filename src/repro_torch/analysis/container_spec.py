"""Container-spec checker: the ZNN1/ZNS1 wire layouts, declared once.

The on-disk formats (core/container.py's single-blob ZNN1, core/engine.py's
framed ZNS1) are hand-written ``struct`` code; the golden fixtures freeze
the bytes but can't point at *which line* drifted.  This family declares
each layout once as a field table and cross-checks every ``struct`` use in
the two format-owning modules against it.

Rules
-----
spec-format            ``struct.Struct(...)`` assignments in the
                       format-owning modules must bind a declared layout
                       name to exactly its declared format string; any
                       other ``struct`` framing in ``src/repro_torch`` is
                       undeclared and flagged (declare it here first).
spec-magic             the module owning a layout must carry its magic
                       literal (b"ZNN1" / b"ZNS1").
spec-arity             ``<layout>.pack(...)`` argument counts and tuple
                       targets of ``<layout>.unpack[_from](...)`` must
                       match the field count (pad fields carry no value).
spec-unchecked-length  a multi-byte integer field bound from ``unpack``
                       (e.g. a u64 ``comp_len``) must not drive an
                       allocation (``fp.read(n)``, ``bytes(n)``,
                       ``bytearray(n)``) before a bounds check: a flipped
                       header byte must never become a giant upfront
                       allocation.  A prior ``Compare`` mentioning the
                       name, or a ``min()`` clamp, counts as the check.
"""

from __future__ import annotations

import ast
import struct as _struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .base import Project, SourceFile, Violation, dotted_name

FAMILY = "container_spec"
RULES = ("spec-format", "spec-magic", "spec-arity", "spec-unchecked-length")


@dataclass(frozen=True)
class FieldSpec:
    name: str
    fmt: str  # single struct format unit, e.g. "Q", "4s", "3x"

    @property
    def width(self) -> int:
        return _struct.calcsize("<" + self.fmt)

    @property
    def is_pad(self) -> bool:
        return self.fmt.endswith("x")


@dataclass(frozen=True)
class LayoutSpec:
    var: str
    fields: Tuple[FieldSpec, ...]
    magic: Optional[bytes] = None

    @property
    def format(self) -> str:
        return "<" + "".join(f.fmt for f in self.fields)

    @property
    def value_fields(self) -> Tuple[FieldSpec, ...]:
        return tuple(f for f in self.fields if not f.is_pad)


def _layout(var: str, fields: Sequence[Tuple[str, str]], magic=None) -> LayoutSpec:
    return LayoutSpec(var, tuple(FieldSpec(n, f) for n, f in fields), magic)


# --- The single source of truth for the wire formats -----------------------
ZNN1_HEADER = _layout(
    "_HDR",
    [
        ("magic", "4s"),
        ("version", "H"),
        ("flags", "H"),
        ("layout", "16s"),
        ("n_bytes", "Q"),
        ("chunk_bytes", "I"),
        ("n_planes", "B"),
        ("_pad", "3x"),
    ],
    magic=b"ZNN1",
)
ZNN1_RECORD = _layout(
    "_REC", [("method", "B"), ("comp_len", "I"), ("crc", "I")]
)
ZNS1_HEADER = _layout(
    "_SHDR",
    [
        ("magic", "4s"),
        ("version", "H"),
        ("flags", "H"),
        ("dtype", "16s"),
        ("window", "Q"),
    ],
    magic=b"ZNS1",
)
ZNS1_FRAME = _layout(
    "_FRAME",
    [("kind", "B"), ("raw_len", "Q"), ("comp_len", "Q"), ("crc", "I")],
)

SPEC: Dict[str, Dict[str, LayoutSpec]] = {
    "src/repro_torch/core/container.py": {"_HDR": ZNN1_HEADER, "_REC": ZNN1_RECORD},
    "src/repro_torch/core/engine.py": {"_SHDR": ZNS1_HEADER, "_FRAME": ZNS1_FRAME},
}

# Any struct use outside these modules is undeclared framing.
STRUCT_SCOPE_PREFIX = "src/repro_torch/"

_ALLOC_BUILTINS = ("bytes", "bytearray")


def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    for sf in project.files:
        layouts = SPEC.get(sf.rel)
        if layouts is not None:
            out.extend(_check_format_module(sf, layouts))
        elif sf.rel.startswith(STRUCT_SCOPE_PREFIX):
            out.extend(_check_no_struct(sf))
    return out


def _check_no_struct(sf: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            if name.startswith("struct."):
                out.append(
                    Violation(
                        "spec-format",
                        sf.rel,
                        node.lineno,
                        f"{name}() outside the format-owning modules — "
                        "wire framing lives in core/container.py / "
                        "core/engine.py with a layout declared in "
                        "analysis/container_spec.py",
                    )
                )
    return out


def _check_format_module(
    sf: SourceFile, layouts: Dict[str, LayoutSpec]
) -> List[Violation]:
    out: List[Violation] = []
    seen_vars: Dict[str, LayoutSpec] = {}

    for node in ast.walk(sf.tree):
        # --- struct.Struct("<fmt>") assignments ---------------------------
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            call = node.value
            if dotted_name(call.func) in ("struct.Struct", "Struct"):
                target = (
                    node.targets[0].id
                    if len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    else None
                )
                fmt = (
                    call.args[0].value
                    if call.args
                    and isinstance(call.args[0], ast.Constant)
                    and isinstance(call.args[0].value, str)
                    else None
                )
                spec = layouts.get(target) if target else None
                if spec is None:
                    out.append(
                        Violation(
                            "spec-format",
                            sf.rel,
                            node.lineno,
                            f"struct.Struct bound to "
                            f"{target or '<non-name target>'} has no "
                            "declared layout — add a field table to "
                            "analysis/container_spec.py",
                        )
                    )
                elif fmt != spec.format:
                    out.append(
                        Violation(
                            "spec-format",
                            sf.rel,
                            node.lineno,
                            f"{target} format {fmt!r} != declared "
                            f"{spec.format!r} "
                            f"({', '.join(f.name + ':' + f.fmt for f in spec.fields)})",
                        )
                    )
                else:
                    seen_vars[target] = spec

        # --- bare struct.pack/unpack with inline formats ------------------
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name in ("struct.pack", "struct.unpack", "struct.pack_into", "struct.unpack_from"):
                out.append(
                    Violation(
                        "spec-format",
                        sf.rel,
                        node.lineno,
                        f"inline {name}() bypasses the declared layout "
                        "Structs — use the module-level layout objects",
                    )
                )

        # --- pack arity ---------------------------------------------------
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            recv = node.func.value
            if isinstance(recv, ast.Name) and recv.id in layouts:
                spec = layouts[recv.id]
                n_fields = len(spec.value_fields)
                if node.func.attr == "pack":
                    if not any(isinstance(a, ast.Starred) for a in node.args):
                        if len(node.args) != n_fields:
                            out.append(
                                Violation(
                                    "spec-arity",
                                    sf.rel,
                                    node.lineno,
                                    f"{recv.id}.pack() takes "
                                    f"{len(node.args)} args but the layout "
                                    f"declares {n_fields} value fields",
                                )
                            )

    # --- declared layouts must all be bound ------------------------------
    for var, spec in layouts.items():
        if var not in seen_vars:
            out.append(
                Violation(
                    "spec-format",
                    sf.rel,
                    1,
                    f"declared layout {var} ({spec.format!r}) is not bound "
                    "via struct.Struct in this module",
                )
            )
        if spec.magic is not None and not _has_bytes_literal(sf, spec.magic):
            out.append(
                Violation(
                    "spec-magic",
                    sf.rel,
                    1,
                    f"magic literal {spec.magic!r} for layout {var} not "
                    "found in this module",
                )
            )

    # --- unpack arity + unchecked length-driven allocation ----------------
    for fn in _functions(sf):
        out.extend(_check_parse_site(sf, fn, layouts))
    return out


def _has_bytes_literal(sf: SourceFile, value: bytes) -> bool:
    return any(
        isinstance(n, ast.Constant) and n.value == value
        for n in ast.walk(sf.tree)
    )


def _functions(sf: SourceFile):
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _unpack_call_layout(
    node: ast.AST, layouts: Dict[str, LayoutSpec]
) -> Optional[LayoutSpec]:
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in ("unpack", "unpack_from")
        and isinstance(node.func.value, ast.Name)
    ):
        return layouts.get(node.func.value.id)
    return None


def _check_parse_site(
    sf: SourceFile, fn: ast.AST, layouts: Dict[str, LayoutSpec]
) -> List[Violation]:
    out: List[Violation] = []
    # name -> (field, bound_line) for names bound by tuple-unpack of a layout
    bound: Dict[str, Tuple[FieldSpec, int]] = {}

    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        spec = _unpack_call_layout(node.value, layouts)
        if spec is None:
            continue
        target = node.targets[0] if len(node.targets) == 1 else None
        if isinstance(target, ast.Tuple):
            names = target.elts
            if len(names) != len(spec.value_fields):
                out.append(
                    Violation(
                        "spec-arity",
                        sf.rel,
                        node.lineno,
                        f"{spec.var}.unpack target unpacks "
                        f"{len(names)} names but the layout declares "
                        f"{len(spec.value_fields)} value fields",
                    )
                )
                continue
            for name_node, fld in zip(names, spec.value_fields):
                if isinstance(name_node, ast.Name):
                    bound[name_node.id] = (fld, node.lineno)

    if not bound:
        return out

    # Guards: lines of Compare nodes / min() calls mentioning a bound name.
    guard_lines: Dict[str, List[int]] = {n: [] for n in bound}

    def names_in(e: ast.AST):
        return {
            n.id for n in ast.walk(e) if isinstance(n, ast.Name)
        } & set(bound)

    for node in ast.walk(fn):
        if isinstance(node, ast.Compare):
            for n in names_in(node):
                guard_lines[n].append(node.lineno)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id == "min":
                for n in names_in(node):
                    guard_lines[n].append(node.lineno)

    def guarded(name: str, before_line: int) -> bool:
        return any(line <= before_line for line in guard_lines[name])

    # Allocation sinks fed directly by a bound wide-integer name.
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        sink = None
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "read"
            and node.args
        ):
            sink = node.args[0]
            what = "a .read() of"
        elif (
            isinstance(node.func, ast.Name)
            and node.func.id in _ALLOC_BUILTINS
            and node.args
        ):
            sink = node.args[0]
            what = f"a {node.func.id}() of"
        if sink is None or not isinstance(sink, ast.Name):
            continue
        info = bound.get(sink.id)
        if info is None:
            continue
        fld, _bline = info
        if fld.is_pad or fld.fmt.endswith("s") or fld.width <= 1:
            continue  # strings / 1-byte fields can't drive huge allocations
        if guarded(sink.id, node.lineno):
            continue
        out.append(
            Violation(
                "spec-unchecked-length",
                sf.rel,
                node.lineno,
                f"{what} {sink.id} (u{fld.width * 8} wire field "
                f"'{fld.name}') with no prior bounds check — a corrupt "
                "length field drives an unbounded allocation; clamp "
                "(min) or validate first",
            )
        )
    return out
