"""CUDA kernel-contract checker: each ``ctypes`` binding in
``src/repro_torch/kernels/`` against its ``extern "C"`` signature in
``src/repro_torch/csrc/*.cu``.

A ``ctypes`` call passes its arguments as its ``argtypes`` list says and
trusts it: a list one entry short shifts every later argument by a
register, an ``int`` where the C side takes a ``long long`` leaves the
upper half of a size as garbage, and nothing fails until a kernel reads or
writes the wrong bytes.  The C signatures are the contract; this family
reads them from the sources the kernels build from and checks every
binding against them.

Rules
-----
kernel-arity        an ``argtypes`` list must have one entry per
                    parameter of the ``extern "C"`` function it binds.
kernel-argtype      each entry's class must match its parameter's:
                    pointer (``c_void_p``, ``c_char_p``, ``POINTER(..)``
                    against any ``T*``), 64-bit integer (``c_longlong``,
                    ``c_int64``, ``c_long``, ``c_size_t`` ... against
                    ``long long``, ``int64_t``, ``size_t`` ...), 32-bit
                    integer (``c_int``, ``c_uint``, ``c_int32`` ... against
                    ``int``, ``unsigned``, ``int32_t`` ...), float
                    (``c_float`` / ``float``), double.
kernel-restype      a ``restype`` must match the function's return type
                    the same way (``None`` for ``void``).
kernel-symbol       a binding to a library built from a source of
                    ``csrc/`` (``_build.load("<name>")``) must name an
                    ``extern "C"`` function of that source.

A binding is ``<expr>.<symbol>.argtypes = <list>`` or ``fn.argtypes =
<list>`` where ``fn = <expr>.<symbol>`` in the same function.  The list
may be built from literals, ``+``, ``* n`` and names bound in the same
function to ``ctypes`` types (``p, i = ctypes.c_void_p, ctypes.c_int``).
A binding whose symbol or list is not static (``getattr`` with a computed
name, a dict of libraries) is not checked.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from .base import Project, SourceFile, Violation, dotted_name

FAMILY = "kernel_contract"
RULES = ("kernel-arity", "kernel-argtype", "kernel-restype", "kernel-symbol")

SCOPE = ("src/repro_torch/kernels/",)
CSRC = "src/repro_torch/csrc/"

# ctypes type → argument class
_CTYPES: Dict[str, str] = {
    "c_void_p": "ptr", "c_char_p": "ptr", "c_wchar_p": "ptr", "POINTER": "ptr",
    "c_longlong": "i64", "c_ulonglong": "i64", "c_int64": "i64", "c_uint64": "i64",
    "c_long": "i64", "c_ulong": "i64", "c_size_t": "i64", "c_ssize_t": "i64",
    "c_int": "i32", "c_uint": "i32", "c_int32": "i32", "c_uint32": "i32",
    "c_short": "i16", "c_ushort": "i16", "c_int16": "i16", "c_uint16": "i16",
    "c_byte": "i8", "c_ubyte": "i8", "c_int8": "i8", "c_uint8": "i8", "c_char": "i8",
    "c_bool": "i8", "c_float": "f32", "c_double": "f64",
}

# C scalar type (qualifiers dropped, spaces normalised) → argument class
_C_TYPES: Dict[str, str] = {
    "long long": "i64", "unsigned long long": "i64", "long long int": "i64",
    "int64_t": "i64", "uint64_t": "i64", "long": "i64", "unsigned long": "i64",
    "size_t": "i64", "ssize_t": "i64", "ptrdiff_t": "i64", "intptr_t": "i64",
    "uintptr_t": "i64",
    "int": "i32", "unsigned": "i32", "unsigned int": "i32", "int32_t": "i32",
    "uint32_t": "i32", "cudaError_t": "i32",
    "short": "i16", "unsigned short": "i16", "int16_t": "i16", "uint16_t": "i16",
    "char": "i8", "unsigned char": "i8", "signed char": "i8", "int8_t": "i8",
    "uint8_t": "i8", "bool": "i8",
    "float": "f32", "double": "f64", "void": "void",
}

_QUALIFIERS = {"const", "volatile", "__restrict__", "restrict", "struct", "static",
               "inline", "__host__", "__device__"}


# ---------------------------------------------------------------------------
# The C side
# ---------------------------------------------------------------------------

def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", lambda m: "\n" * m.group(0).count("\n"), text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _extern_c_regions(text: str) -> List[Tuple[int, str]]:
    """``(offset, text)`` of every ``extern "C"`` block body or single
    declaration."""
    out = []
    for m in re.finditer(r'extern\s+"C"\s*', text):
        i = m.end()
        if text.startswith("{", i):
            depth, j = 0, i
            while j < len(text):
                if text[j] == "{":
                    depth += 1
                elif text[j] == "}":
                    depth -= 1
                    if depth == 0:
                        break
                j += 1
            out.append((i + 1, text[i + 1:j]))
        else:
            stops = [x for x in (text.find("{", i), text.find(";", i)) if x >= 0]
            stop = min(stops) if stops else len(text)
            out.append((i, text[i:stop + 1]))
    return out


def _top_level(body: str) -> str:
    """``body`` with every brace-enclosed function body blanked, so only
    top-level declarations remain."""
    out, depth = [], 0
    for ch in body:
        if ch == "{":
            depth += 1
            out.append("{" if depth == 1 else " ")
        elif ch == "}":
            depth -= 1
            out.append(" ")
        else:
            out.append(ch if depth == 0 or ch == "\n" else " ")
    return "".join(out)


_SIG_RE = re.compile(
    r"(?P<ret>[A-Za-z_][\w\s\*]*?[\s\*])(?P<name>[A-Za-z_]\w*)\s*\((?P<params>[^()]*)\)\s*[{;]")


def _class_of_c(decl: str) -> Optional[str]:
    """The class of a C parameter or return type (its name dropped)."""
    decl = re.sub(r"\[[^\]]*\]", "*", decl)          # arrays decay to pointers
    if "*" in decl:
        return "ptr"
    words = [w for w in decl.split() if w not in _QUALIFIERS]
    for n in (len(words), len(words) - 1):              # with or without a parameter name
        if n > 0:
            key = " ".join(words[:n])
            if key in _C_TYPES:
                return _C_TYPES[key]
    return None


def c_signatures(text: str) -> Dict[str, Tuple[int, Optional[str], Tuple[Optional[str], ...]]]:
    """``{name: (line, return class, (parameter classes))}`` of every
    function of a CUDA source's ``extern "C"`` blocks."""
    text = _strip_comments(text)
    out = {}
    for off, body in _extern_c_regions(text):
        flat = _top_level(body)
        for m in _SIG_RE.finditer(flat):
            params = m.group("params").strip()
            plist = [] if params in ("", "void") else [p.strip() for p in params.split(",")]
            line = text.count("\n", 0, off + m.start("name")) + 1
            out[m.group("name")] = (line, _class_of_c(m.group("ret")),
                                    tuple(_class_of_c(p) for p in plist))
    return out


# ---------------------------------------------------------------------------
# The Python side
# ---------------------------------------------------------------------------

def _aliases(fn: Optional[ast.AST], tree: ast.AST) -> Dict[str, ast.AST]:
    """Names bound by plain assignment in ``fn`` (or the module), last
    binding wins: ``{name: value node}``."""
    out: Dict[str, ast.AST] = {}
    body = ast.walk(fn) if fn is not None else iter(getattr(tree, "body", []))
    for node in body:
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                out[tgt.id] = node.value
            elif (isinstance(tgt, ast.Tuple) and isinstance(node.value, ast.Tuple)
                  and len(tgt.elts) == len(node.value.elts)):
                for t, v in zip(tgt.elts, node.value.elts):
                    if isinstance(t, ast.Name):
                        out[t.id] = v
    return out


def _ctype_class(node: ast.AST, aliases: Dict[str, ast.AST], depth: int = 0) -> Optional[str]:
    if depth > 8:
        return None
    if isinstance(node, ast.Call):
        name = dotted_name(node.func) or ""
        return "ptr" if name.split(".")[-1] == "POINTER" else None
    if isinstance(node, ast.Name) and node.id in aliases:
        return _ctype_class(aliases[node.id], aliases, depth + 1)
    if isinstance(node, ast.Constant) and node.value is None:
        return "void"
    name = dotted_name(node)
    if name is None:
        return None
    return _CTYPES.get(name.split(".")[-1])


def _type_list(node: ast.AST, aliases: Dict[str, ast.AST], depth: int = 0) -> Optional[List[str]]:
    """The classes of a static ``argtypes`` expression, or None."""
    if depth > 8:
        return None
    if isinstance(node, (ast.List, ast.Tuple)):
        out = [_ctype_class(e, aliases) for e in node.elts]
        return None if any(c is None for c in out) else out
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _type_list(node.left, aliases, depth + 1), _type_list(node.right, aliases, depth + 1)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, n in ((node.left, node.right), (node.right, node.left)):
            if isinstance(n, ast.Constant) and isinstance(n.value, int):
                items = _type_list(seq, aliases, depth + 1)
                return None if items is None else items * n.value
        return None
    if isinstance(node, ast.Name) and node.id in aliases:
        return _type_list(aliases[node.id], aliases, depth + 1)
    return None


def _library_source(node: ast.AST, aliases: Dict[str, ast.AST], depth: int = 0) -> Optional[str]:
    """``name`` where ``node`` is ``_build.load("name")`` (through
    aliases), else None."""
    if depth > 8:
        return None
    if isinstance(node, ast.Name) and node.id in aliases:
        return _library_source(aliases[node.id], aliases, depth + 1)
    if isinstance(node, ast.Call) and (dotted_name(node.func) or "").endswith("load") \
            and node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0].value
    return None


def _symbol(target: ast.AST, aliases: Dict[str, ast.AST]) -> Tuple[Optional[str], Optional[str]]:
    """``(symbol, library source name)`` a binding target names."""
    base = target.value if isinstance(target, ast.Attribute) else None
    if isinstance(base, ast.Name) and base.id in aliases:
        base = aliases[base.id]
    if isinstance(base, ast.Attribute):
        return base.attr, _library_source(base.value, aliases)
    return None, None


def bindings(sf: SourceFile):
    """``(line, kind, symbol, library, classes)`` of every static
    ``argtypes`` / ``restype`` assignment in a kernel module."""
    out = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not (isinstance(tgt, ast.Attribute) and tgt.attr in ("argtypes", "restype")):
            continue
        aliases = _aliases(sf.enclosing_function(node), sf.tree)
        symbol, lib = _symbol(tgt, aliases)
        if symbol is None:
            continue
        if tgt.attr == "argtypes":
            classes = _type_list(node.value, aliases)
        else:
            c = _ctype_class(node.value, aliases)
            classes = None if c is None else [c]
        if classes is None:
            continue
        out.append((node.lineno, tgt.attr, symbol, lib, classes))
    return out


def check(project: Project) -> List[Violation]:
    sigs: Dict[str, Dict[str, Tuple[int, Optional[str], Tuple[Optional[str], ...]]]] = {}
    for rel, text in sorted(project.extra.items()):
        if rel.startswith(CSRC) and rel.endswith(".cu"):
            sigs[rel[len(CSRC):-3]] = c_signatures(text)
    by_symbol: Dict[str, List[Tuple[str, tuple]]] = {}
    for src, table in sigs.items():
        for name, sig in table.items():
            by_symbol.setdefault(name, []).append((src, sig))

    out: List[Violation] = []
    for sf in project.under(*SCOPE):
        for line, kind, symbol, lib, classes in bindings(sf):
            if lib is not None and lib in sigs:
                sig = sigs[lib].get(symbol)
                where = f"csrc/{lib}.cu"
            elif lib is None and len(by_symbol.get(symbol, ())) == 1:
                src, sig = by_symbol[symbol][0]
                where = f"csrc/{src}.cu"
            else:
                sig, where = None, None
            if sig is None:
                if lib is not None and lib in sigs:
                    out.append(Violation(
                        "kernel-symbol", sf.rel, line,
                        f"{symbol} is bound from library {lib!r}, whose source "
                        f"{where} has no extern \"C\" function of that name"))
                continue
            _, ret, params = sig
            if kind == "restype":
                if ret is not None and classes[0] != ret:
                    out.append(Violation(
                        "kernel-restype", sf.rel, line,
                        f"{symbol}.restype is a {classes[0]} type, the C function in "
                        f"{where} returns {ret}"))
                continue
            if len(classes) != len(params):
                out.append(Violation(
                    "kernel-arity", sf.rel, line,
                    f"{symbol}.argtypes has {len(classes)} entries, the C function in "
                    f"{where} takes {len(params)} parameters"))
                continue
            for i, (py, c) in enumerate(zip(classes, params)):
                if c is not None and py != c:
                    out.append(Violation(
                        "kernel-argtype", sf.rel, line,
                        f"{symbol}.argtypes[{i}] is a {py} type, parameter {i} of the C "
                        f"function in {where} is {c}"))
    return out
