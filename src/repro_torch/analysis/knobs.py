"""Knob-threading checker: ``threads`` / ``backend`` / ``entropy_backend``
forwarded end-to-end.

The repo's invariant only holds if every entry point threads the three
execution knobs down to ``engine`` / ``device_*`` unchanged — a dropped
kwarg silently re-defaults a layer and the parity suite catches it only if
a test happens to cross that edge with a non-default value.  This family
checks the whole call graph statically.

Scope: the modules that form the public compression surface and its
plumbing (``core/zipnn.py``, ``core/engine.py``, ``checkpoint/manager.py``,
``checkpoint/hub.py``, ``distributed/grad_sync.py``,
``serve/compressed.py`` + the ring scheduler in ``serve/step.py``).

Model
-----
* A function *has* a knob K if K is among its parameters, or it is a
  method of a class whose ``__init__`` takes K (instance-carried, e.g.
  ``CompressWriter._compress`` via ``self._backend``).
* A call edge caller→callee where the caller has K and the callee accepts
  K must pass K — by keyword, positionally, or via ``**kwargs``:

  - passes nothing for K           → ``knob-dropped``
  - passes a non-None literal      → ``knob-redefault`` (overrides the
    caller's knob with a constant; if intentional, suppress with a reason)
  - explicit ``K=None``            → allowed (None is the "derive from
    config" default everywhere on this surface)

* The unified bag (``core/options.py``) is a knob too: ``options`` rides
  the same model, so dropping it on an edge is caught like any other.  An
  edge that binds ``options=`` to a non-None value *supersedes* the three
  legacy knob checks on that edge — the bag carries them, which is the
  whole point of the redesign.  ``CodecOptions(...)`` constructor calls
  themselves are exempt: building a bag from locals (or an intentional
  constant, e.g. the host fallback for device-skipped leaves) IS the
  forwarding mechanism, and the edge that consumes the bag is where
  threading is enforced.

* Callers *without* K in scope are exempt: passing knobs via a config
  object (``CheckpointManager`` / ``CheckpointConfig.zipnn``) is the
  sanctioned config-carried path.

``knob-surface`` pins the public contract: the declared entry points must
keep accepting their knob sets, so a signature regression is caught even
though no in-repo call exercises it.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .base import Project, SourceFile, Violation

FAMILY = "knobs"
RULES = ("knob-dropped", "knob-redefault", "knob-surface")

LEGACY_KNOBS = ("threads", "backend", "entropy_backend")
BAG = "options"
KNOBS = LEGACY_KNOBS + (BAG,)

SCOPE = (
    "src/repro_torch/core/zipnn.py",
    "src/repro_torch/core/engine.py",
    "src/repro_torch/core/options.py",
    "src/repro_torch/checkpoint/",
    "src/repro_torch/distributed/",
    "src/repro_torch/serve/",
)

# The bag constructor: building a CodecOptions from knob locals (or an
# intentional constant) is itself the forwarding act — its edges are exempt.
_BAG_CLASS = "CodecOptions"

# The public-surface contract: entry point -> knobs it must accept.
# Decompression takes entropy_backend too: the container records the
# *coder*, but the knob picks where its Huffman chunks decode (host work
# items vs the device decoder kernel) — bytes identical either way.
# Every legacy entry point must now ALSO accept the unified options= bag
# (the api_redesign contract); new surfaces (session, KV tier) are
# bag-only — they never grew the loose kwargs.
_CBE = frozenset(("threads", "backend", "entropy_backend"))
_CBEO = _CBE | frozenset((BAG,))
_O = frozenset((BAG,))
# The port's surface is the reference's, plus what the port's callers
# reach directly: the config dataclass that carries the three knobs, the
# payload feed the serving ring builds (bag-only), and the store's
# ``from_params`` constructor.  It pins, among the rest, the codec entry
# points' acceptance of the legacy knobs beside ``options=``.
SURFACE: Dict[str, Dict[str, frozenset]] = {
    "src/repro_torch/core/zipnn.py": {
        "ZipNNConfig": _CBE,
        "build_array_feed": _O,
        "compress_bytes": _CBEO,
        "compress_array": _CBEO,
        "compress_pytree": _CBEO,
        "delta_compress": _CBEO,
        "delta_compress_batched": _CBEO,
        "decompress_bytes": _CBEO,
        "decompress_array": _CBEO,
        "decompress_pytree": _CBEO,
        "delta_decompress": _CBEO,
    },
    "src/repro_torch/core/engine.py": {
        "compress_file": _CBEO,
        "CompressWriter": _CBEO,
        "decompress_file": _CBEO,
        "DecompressReader": _CBEO,
    },
    # The bag itself: CodecOptions must keep its three codec-knob fields
    # (device_resident is a semantic flag, outside the knob set), the shim
    # must accept bag + legacy kwargs, the session is bag-only.
    "src/repro_torch/core/options.py": {
        "CodecOptions": _CBE,
        "resolve_options": _CBEO,
        "ZipNNSession": _O,
    },
    "src/repro_torch/checkpoint/hub.py": {
        "simulate_transfer": _CBEO,
        "simulate_file_transfer": _CBEO,
    },
    "src/repro_torch/checkpoint/manager.py": {
        "CheckpointConfig": _CBEO,
    },
    "src/repro_torch/distributed/grad_sync.py": {
        "GradSync": _CBEO,
    },
    # The compressed-resident serving store carries the knobs for every
    # ring decode; the ring scheduler itself is knob-free (store-carried,
    # like CheckpointManager's config-carried path).
    "src/repro_torch/serve/compressed.py": {
        "CompressedParamStore": _CBEO,
        "from_params": _CBEO,
    },
    "src/repro_torch/serve/kvcache.py": {
        "KVCacheStore": _O,
    },
}


@dataclass
class Callable_:
    """A resolvable call target: function, method, or class constructor."""

    name: str
    rel: str
    lineno: int
    params: Tuple[str, ...]  # positional+kw params, self/cls stripped
    has_kwargs: bool
    knob_fields: Set[str] = field(default_factory=set)  # classes: knob fields

    def knobs(self) -> Set[str]:
        return {k for k in KNOBS if k in self.params} | self.knob_fields


def _func_params(fn: ast.FunctionDef) -> Tuple[Tuple[str, ...], bool]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if names and names[0] in ("self", "cls"):
        names = names[1:]
    return tuple(names), a.kwarg is not None


def _collect(project: Project) -> Dict[str, List[Callable_]]:
    """Registry: bare name -> candidates, across all scope modules."""
    reg: Dict[str, List[Callable_]] = {}

    def add(c: Callable_) -> None:
        reg.setdefault(c.name, []).append(c)

    for sf in project.under(*SCOPE):
        for node in sf.tree.body:
            if isinstance(node, ast.FunctionDef):
                params, kw = _func_params(node)
                add(Callable_(node.name, sf.rel, node.lineno, params, kw))
            elif isinstance(node, ast.ClassDef):
                fields: Set[str] = set()
                init: Optional[ast.FunctionDef] = None
                for item in node.body:
                    if isinstance(item, ast.AnnAssign) and isinstance(
                        item.target, ast.Name
                    ):
                        if item.target.id in KNOBS:
                            fields.add(item.target.id)
                    elif isinstance(item, ast.FunctionDef):
                        if item.name == "__init__":
                            init = item
                        params, kw = _func_params(item)
                        add(
                            Callable_(
                                item.name, sf.rel, item.lineno, params, kw
                            )
                        )
                if init is not None:
                    params, kw = _func_params(init)
                else:
                    params, kw = tuple(sorted(fields)), False
                add(
                    Callable_(
                        node.name, sf.rel, node.lineno, params, kw, fields
                    )
                )
    return reg


def _class_init_knobs(sf: SourceFile, cls: ast.ClassDef) -> Set[str]:
    knobs: Set[str] = set()
    for item in cls.body:
        if isinstance(item, ast.FunctionDef) and item.name == "__init__":
            params, _ = _func_params(item)
            knobs |= {k for k in KNOBS if k in params}
        if isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
            if item.target.id in KNOBS:
                knobs.add(item.target.id)
    return knobs


def _caller_knobs(sf: SourceFile, node: ast.AST) -> Set[str]:
    """Knobs in scope at ``node``: enclosing function params + the class's
    instance-carried knobs (its ``__init__`` params / annotated fields)."""
    fn = sf.enclosing_function(node)
    if fn is None:
        return set()
    params, _ = _func_params(fn)
    knobs = {k for k in KNOBS if k in params}
    cur = sf.parent(fn)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            knobs |= _class_init_knobs(sf, cur)
            break
        cur = sf.parent(cur)
    return knobs


def _passed_value(call: ast.Call, callee: Callable_, knob: str):
    """(found, value): how this call binds ``knob`` in the callee.

    Returns (True, node-or-None) when bound (None value = bound via
    ``**kwargs`` or unmappable positionals — treated as forwarded), else
    (False, None).
    """
    for kw in call.keywords:
        if kw.arg == knob:
            return True, kw.value
        if kw.arg is None:  # **kwargs forwarding
            return True, None
    try:
        idx = callee.params.index(knob)
    except ValueError:
        return False, None
    if any(isinstance(a, ast.Starred) for a in call.args[: idx + 1]):
        return True, None  # *args before the slot: not statically mappable
    if idx < len(call.args):
        return True, call.args[idx]
    return False, None


def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    reg = _collect(project)

    # --- call-edge checks --------------------------------------------------
    for sf in project.under(*SCOPE):
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute):
                tail = fn.attr
            elif isinstance(fn, ast.Name):
                tail = fn.id
            else:
                continue
            if tail == _BAG_CLASS:
                continue  # bag construction IS the forwarding mechanism
            candidates = reg.get(tail, ())
            caller = _caller_knobs(sf, node)
            for cand in candidates:
                # An edge that forwards a non-None options= bag satisfies
                # the three legacy knobs — they ride inside it.
                bag_bound = False
                if BAG in cand.params or cand.has_kwargs:
                    bfound, bval = _passed_value(node, cand, BAG)
                    bag_bound = bfound and not (
                        isinstance(bval, ast.Constant) and bval.value is None
                    )
                for knob in KNOBS:
                    if knob not in caller or knob not in cand.params:
                        continue
                    if bag_bound and knob != BAG:
                        continue
                    found, value = _passed_value(node, cand, knob)
                    if not found:
                        out.append(
                            Violation(
                                "knob-dropped",
                                sf.rel,
                                node.lineno,
                                f"call to {cand.name}() drops {knob}= even "
                                f"though {knob} is in scope here — the "
                                "callee silently falls back to its default",
                            )
                        )
                    elif (
                        isinstance(value, ast.Constant)
                        and value.value is not None
                    ):
                        out.append(
                            Violation(
                                "knob-redefault",
                                sf.rel,
                                node.lineno,
                                f"call to {cand.name}() re-defaults "
                                f"{knob}={value.value!r} while the caller's "
                                f"{knob} is in scope — forward it, or "
                                "suppress with a reason if the constant is "
                                "intentional",
                            )
                        )

    # --- public-surface contract ------------------------------------------
    for rel, wanted in SURFACE.items():
        sf = project.get(rel)
        if sf is None:
            continue  # partial project (unit tests) — only check present files
        present = {
            c.name: c for c in sum(reg.values(), []) if c.rel == rel
        }
        for name, knobs in wanted.items():
            cand = present.get(name)
            if cand is None:
                out.append(
                    Violation(
                        "knob-surface",
                        rel,
                        1,
                        f"public entry point {name}() is missing from the "
                        "compression surface",
                    )
                )
                continue
            missing = knobs - set(cand.params) - cand.knob_fields
            if missing:
                out.append(
                    Violation(
                        "knob-surface",
                        rel,
                        cand.lineno,
                        f"{name}() must accept knob(s) "
                        f"{', '.join(sorted(missing))} — the public "
                        "surface contract (docs/INVARIANTS.md)",
                    )
                )
    return out
