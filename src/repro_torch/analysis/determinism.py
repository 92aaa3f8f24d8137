"""Determinism lint: nondeterminism sources on codec paths.

Scope: ``src/repro_torch/{core,kernels,checkpoint,distributed}``.  Everything in
these trees sits on (or next to) the path that produces compressed bytes,
where the repo invariant is *byte-identical output across backend x
entropy_backend x threads — and across runs*.  Benchmarks and tests live
outside the scope and may use clocks/RNGs freely.

Rules
-----
det-wallclock   calendar-time calls (``time.time``, ``datetime.now`` ...).
                ``time.perf_counter``/``monotonic`` are allowed: they are
                measurement clocks whose values feed reports, not bytes.
det-random      RNG / entropy sources: ``random.*``, ``np.random.*``,
                ``os.urandom``, ``uuid.*``, ``secrets.*``; and torch's:
                ``torch.rand*`` / ``randn*`` / ``randint*`` /
                ``randperm``, ``torch.normal`` / ``bernoulli`` /
                ``multinomial`` / ``poisson``, ``torch.random.*``,
                ``torch.seed`` and ``torch.cuda.seed*``, a generator's
                ``.seed()``, and the in-place draws (``.uniform_()``,
                ``.normal_()``, ``.random_()``, ``.bernoulli_()``,
                ``.exponential_()``, ``.geometric_()``, ``.cauchy_()``,
                ``.log_normal_()``).  torch's measurement clocks
                (``torch.cuda.Event`` timings) are allowed, as
                ``perf_counter`` is.
det-hash        builtin ``hash()`` — salted per process (PYTHONHASHSEED).
det-set-order   iterating a set (literal, comprehension, ``set()`` /
                ``frozenset()`` call) without ``sorted()`` — iteration
                order varies run to run.
det-id-key      ``id(x)`` used as a subscript/dict key — address-derived
                keys reorder dicts run to run.
det-fs-order    iterating ``os.listdir`` / ``os.scandir`` / ``glob.glob``
                / ``.iterdir()`` without ``sorted()`` — directory order is
                filesystem-dependent.
det-float-size  float division feeding a byte count, slice bound,
                ``range()`` or array allocation — sizes on byte-exact
                paths must stay in integer arithmetic (``//``, ``-(-a//b)``).
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .base import Project, SourceFile, Violation, dotted_name, is_call_to

FAMILY = "determinism"
RULES = (
    "det-wallclock",
    "det-random",
    "det-hash",
    "det-set-order",
    "det-id-key",
    "det-fs-order",
    "det-float-size",
)

SCOPE = (
    "src/repro_torch/core/",
    "src/repro_torch/kernels/",
    "src/repro_torch/checkpoint/",
    "src/repro_torch/distributed/",
)

_WALLCLOCK = (
    "time.time",
    "time.time_ns",
    "time.ctime",
    "time.localtime",
    "time.gmtime",
    "datetime.now",
    "datetime.utcnow",
    "datetime.today",
    "date.today",
)

_RANDOM_PREFIXES = ("random.", "np.random.", "numpy.random.", "secrets.", "uuid.",
                    "torch.random.")
_RANDOM_EXACT = ("os.urandom", "torch.seed", "torch.cuda.seed", "torch.cuda.seed_all")
_TORCH_DRAWS = ("rand", "randn", "randint", "randperm", "rand_like", "randn_like",
                "randint_like", "normal", "bernoulli", "multinomial", "poisson")
_INPLACE_DRAWS = ("uniform_", "normal_", "random_", "bernoulli_", "exponential_",
                  "geometric_", "cauchy_", "log_normal_")


def _is_entropy(name: str, node: ast.Call) -> bool:
    if name in _RANDOM_EXACT or any(name.startswith(p) for p in _RANDOM_PREFIXES):
        return True
    parts = name.split(".")
    if parts[0] == "torch" and len(parts) == 2 and parts[1] in _TORCH_DRAWS:
        return True
    # a generator's reseed from entropy, an in-place draw on a tensor
    return isinstance(node.func, ast.Attribute) and (
        node.func.attr in _INPLACE_DRAWS or (node.func.attr == "seed" and not node.args))

_FS_LISTING = ("os.listdir", "os.scandir", "glob.glob", "glob.iglob")

# Allocation-ish call targets whose size argument must be integer-exact.
_SIZE_SINKS = ("range", "bytes", "bytearray", "memoryview")
_NP_ALLOC_TAILS = ("empty", "zeros", "ones", "full")


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    return False


def _is_fs_listing(node: ast.AST) -> bool:
    if is_call_to(node, *_FS_LISTING):
        return True
    # path.iterdir() / path.glob("*") on a Path-like receiver
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in ("iterdir", "glob", "rglob", "scandir"):
            return True
    return False


def _iteration_context(sf: SourceFile, node: ast.AST) -> Optional[ast.AST]:
    """If ``node`` is directly iterated, return the iterating node.

    Covers ``for x in node``, comprehension generators, and wrapping in
    ``list()`` / ``tuple()`` / ``enumerate()`` (which freeze the order into
    output-feeding sequences).  ``sorted(node)`` neutralizes the order and
    returns None.
    """
    parent = sf.parent(node)
    if isinstance(parent, ast.Call) and isinstance(parent.func, ast.Name):
        if parent.func.id == "sorted":
            return None
        if parent.func.id in ("list", "tuple", "enumerate") and parent.args and parent.args[0] is node:
            return parent
    if isinstance(parent, (ast.For, ast.AsyncFor)) and parent.iter is node:
        return parent
    if isinstance(parent, ast.comprehension) and parent.iter is node:
        return parent
    return None


def _float_size_context(sf: SourceFile, div: ast.BinOp) -> Optional[str]:
    """Climb from a ``/`` BinOp; return a description if it feeds a size."""
    cur: ast.AST = div
    parent = sf.parent(cur)
    # Climb through arithmetic wrappers that keep it float (e.g. a / b + 1).
    while isinstance(parent, (ast.BinOp, ast.UnaryOp)):
        cur = parent
        parent = sf.parent(cur)
    if isinstance(parent, (ast.Slice,)):
        return "slice bound"
    if isinstance(parent, ast.Subscript) and parent.slice is cur:
        return "subscript index"
    if isinstance(parent, ast.Call):
        fn = parent.func
        if isinstance(fn, ast.Name) and fn.id in _SIZE_SINKS and cur in parent.args:
            return f"argument of {fn.id}()"
        if isinstance(fn, ast.Name) and fn.id == "int" and cur in parent.args:
            # int(a / b) truncates a float — rounding drift under
            # fast-math/accumulation; sizes must use //.
            return "int() truncation of a float quotient (use //)"
        name = dotted_name(fn)
        if (
            name is not None
            and name.split(".")[-1] in _NP_ALLOC_TAILS
            and parent.args
            and cur is parent.args[0]
        ):
            return f"shape argument of {name}()"
    return None


def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    for sf in project.under(*SCOPE):
        out.extend(_check_file(sf))
    return out


def _check_file(sf: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    for node in ast.walk(sf.tree):
        # --- clocks / RNG / hash ------------------------------------------
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name is not None:
                if any(name == w or name.endswith("." + w) for w in _WALLCLOCK):
                    out.append(
                        Violation(
                            "det-wallclock",
                            sf.rel,
                            node.lineno,
                            f"wall-clock call {name}() on a codec path — "
                            "use time.perf_counter() for measurements; "
                            "clock values must never feed output bytes",
                        )
                    )
                if _is_entropy(name, node):
                    out.append(
                        Violation(
                            "det-random",
                            sf.rel,
                            node.lineno,
                            f"entropy source {name}() on a codec path — "
                            "compressed bytes must be a pure function of "
                            "the input",
                        )
                    )
            if isinstance(node.func, ast.Name) and node.func.id == "hash":
                out.append(
                    Violation(
                        "det-hash",
                        sf.rel,
                        node.lineno,
                        "builtin hash() is salted per process "
                        "(PYTHONHASHSEED) — use a content hash "
                        "(zlib.crc32, hashlib) instead",
                    )
                )
            # id() as a key
            if isinstance(node.func, ast.Name) and node.func.id == "id":
                parent = sf.parent(node)
                in_subscript = (
                    isinstance(parent, ast.Subscript) and parent.slice is node
                )
                in_dict_key = isinstance(parent, ast.Dict) and node in parent.keys
                in_map_call = (
                    isinstance(parent, ast.Call)
                    and isinstance(parent.func, ast.Attribute)
                    and parent.func.attr in ("get", "setdefault", "pop")
                    and parent.args
                    and parent.args[0] is node
                )
                if in_subscript or in_dict_key or in_map_call:
                    out.append(
                        Violation(
                            "det-id-key",
                            sf.rel,
                            node.lineno,
                            "id()-keyed mapping — addresses vary run to "
                            "run, so iteration order (and any bytes "
                            "derived from it) is nondeterministic",
                        )
                    )

        # --- iteration order ----------------------------------------------
        if _is_set_expr(node):
            ctx = _iteration_context(sf, node)
            if ctx is not None:
                out.append(
                    Violation(
                        "det-set-order",
                        sf.rel,
                        node.lineno,
                        "iterating a set — order varies run to run; wrap "
                        "in sorted(...) before anything that feeds output",
                    )
                )
        if _is_fs_listing(node):
            ctx = _iteration_context(sf, node)
            if ctx is not None:
                out.append(
                    Violation(
                        "det-fs-order",
                        sf.rel,
                        node.lineno,
                        "iterating a directory listing — order is "
                        "filesystem-dependent; wrap in sorted(...)",
                    )
                )

        # --- float-derived sizes ------------------------------------------
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            desc = _float_size_context(sf, node)
            if desc is not None:
                out.append(
                    Violation(
                        "det-float-size",
                        sf.rel,
                        node.lineno,
                        f"float division feeds a {desc} — byte-exact "
                        "paths must size with integer arithmetic "
                        "(// or -(-a // b))",
                    )
                )
    return out
