"""zipnn-lint for the port (``repro_torch.analysis``) against the
reference's (``repro.analysis``), and its own rules.

* The reference's fixture sources (``tests/test_analysis.py``: the
  determinism cases, the knob-threading and container-spec sources) give
  both analyzers the same (rule, line) findings, each under its own
  package's path (``src/repro/...`` → ``src/repro_torch/...``).
* Each of the four families flags a seeded violation: a torch entropy
  source, a port surface entry point without its knob, a drifted ZNS1
  frame format, and ``argtypes`` / ``restype`` lists that disagree with
  their ``extern "C"`` signature (and a binding to a symbol its source
  does not define); the minimally fixed twins pass.
* The C signature reader on the real sources, and every real binding
  checked against one.
* ``python -m repro_torch.analysis --strict`` exits 0 on the tree.
* Importing ``repro_torch.analysis`` loads nothing but the standard
  library.
"""

import importlib.util
import os
import subprocess
import sys
import textwrap

import pytest

import repro.analysis as ref_lint
from repro.analysis import container_spec as ref_container_spec
from repro.analysis import determinism as ref_determinism
from repro.analysis import knobs as ref_knobs
import repro_torch.analysis as port_lint
from repro_torch.analysis import container_spec, determinism, kernel_contract, knobs
from repro_torch.analysis.driver import find_repo_root, load_project

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_tests():
    """The reference's lint test module, for its fixture sources."""
    spec = importlib.util.spec_from_file_location(
        "reference_analysis_tests", os.path.join(REPO, "tests", "test_analysis.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_tests()
PAIRS = {"determinism": (ref_determinism, determinism), "knobs": (ref_knobs, knobs),
         "container_spec": (ref_container_spec, container_spec)}


def _fixtures():
    cases = []
    params = REF.test_determinism_fixtures.pytestmark[0].args[1]
    for i, (rule, bad, good) in enumerate(params):
        cases.append((f"det-{i}-{rule}-bad", bad, REF.CORE, "determinism"))
        cases.append((f"det-{i}-{rule}-good", good, REF.CORE, "determinism"))
    cases.append(("det-benchmarks-scope", "import time\nstamp = time.time()\n",
                  "benchmarks/fake_bench.py", "determinism"))
    for name, fwd in [("dropped", ""), ("forwarded", ", threads=threads, backend=backend"),
                      ("positional", ", threads, backend"),
                      ("redefault", ", threads=threads, backend='host'"),
                      ("none", ", threads=threads, backend=None")]:
        cases.append((f"knob-{name}", REF._KNOB_BASE.format(fwd=fwd), REF.KNOB_SCOPE, "knobs"))
    ok = REF._SPEC_OK_PREFIX
    for name, code in [
            ("ok", ok), ("drift", ok.replace('"<BQQI"', '"<BQII"')),
            ("undeclared", ok + "    _EXTRA = struct.Struct('<II')\n"),
            ("no-magic", ok.replace('    _STREAM_MAGIC = b"ZNS1"\n', "")),
            ("pack-arity", ok + "    rec = _FRAME.pack(1, 2, 3)\n"),
            ("unchecked", REF._PARSE.format(guard="")),
            ("checked", REF._PARSE.format(guard="if comp_len > (64 << 20):\n"
                                          "            raise IOError('frame too large')\n"
                                          "        ")),
            ("clamped", REF._PARSE.format(guard="comp_len = min(comp_len, 64 << 20)\n        "))]:
        cases.append((f"spec-{name}", code, REF.ENGINE, "container_spec"))
    cases.append(("spec-inline", "import struct\nhdr = struct.pack('<I', 1)\n", REF.CORE,
                  "container_spec"))
    return cases


FIXTURES = _fixtures()


def _port_path(rel):
    return rel.replace("src/repro/", "src/repro_torch/")


def _findings(violations):
    return sorted((v.rule, v.line) for v in violations)


@pytest.mark.parametrize("name,code,rel,family", FIXTURES, ids=[f[0] for f in FIXTURES])
def test_reference_fixtures_give_the_same_findings(name, code, rel, family):
    ref_fam, port_fam = PAIRS[family]
    code = textwrap.dedent(code)
    want = ref_lint.analyze_source(code, rel, families=[ref_fam])
    got = port_lint.analyze_source(code, _port_path(rel), families=[port_fam])
    assert _findings(got) == _findings(want)
    if name.endswith("-bad") or name.split("-")[1] in ("dropped", "redefault", "drift"):
        assert got, "a seeded violation must be flagged"


# ---------------------------------------------------------------------------
# Seeded violations, one family at a time
# ---------------------------------------------------------------------------

CORE = "src/repro_torch/core/fake_mod.py"


@pytest.mark.parametrize("bad,good", [
    ("import torch\nx = torch.rand(3)\n", "import torch\nx = torch.zeros(3)\n"),
    ("import torch\nx = torch.randint(0, 9, (3,))\n", "import torch\nx = torch.arange(3)\n"),
    ("def f(t):\n    return t.normal_()\n", "def f(t):\n    return t.zero_()\n"),
    ("import torch\ng = torch.Generator()\ng.seed()\n",
     "import torch\ng = torch.Generator()\ng.manual_seed(0)\n"),
    ("import torch\ntorch.seed()\n", "import torch\ntorch.manual_seed(0)\n"),
])
def test_determinism_flags_torch_entropy(bad, good):
    assert {v.rule for v in port_lint.analyze_source(bad, CORE, [determinism])} == {"det-random"}
    assert not port_lint.analyze_source(good, CORE, [determinism])


def test_determinism_allows_torch_measurement_clocks():
    code = ("import torch\nstart = torch.cuda.Event(enable_timing=True)\n"
            "end = torch.cuda.Event(enable_timing=True)\nms = start.elapsed_time(end)\n")
    assert not port_lint.analyze_source(code, CORE, [determinism])


def test_knob_surface_flags_a_port_entry_point():
    bad = "def build_array_feed(arr, config=None):\n    return None\n"
    good = "def build_array_feed(arr, config=None, options=None):\n    return None\n"
    rel = "src/repro_torch/core/zipnn.py"
    v = [x for x in port_lint.analyze_source(bad, rel, [knobs]) if x.rule == "knob-surface"]
    assert any("build_array_feed" in x.message and "options" in x.message for x in v)
    v = [x for x in port_lint.analyze_source(good, rel, [knobs]) if x.rule == "knob-surface"]
    assert not any("build_array_feed" in x.message for x in v)


def test_container_spec_flags_a_drifted_port_frame():
    ok = textwrap.dedent(REF._SPEC_OK_PREFIX)
    rel = "src/repro_torch/core/engine.py"
    assert not port_lint.analyze_source(ok, rel, [container_spec])
    bad = ok.replace('"<BQQI"', '"<BQIQ"')
    assert {v.rule for v in port_lint.analyze_source(bad, rel, [container_spec])} == {"spec-format"}


CU = '''
#include <cstdint>
extern "C" {
// a: n bytes; count may be null
int demo_launch(const void* a, void* out, long long n, int flags, float scale,
                unsigned int* count) {
  return 0;
}
long long demo_bytes(int itemsize, int tile) { return 0; }
}  // extern "C"
'''

BINDING = '''
import ctypes
from . import _build

def _fn():
    fn = _build.load("demo").demo_launch
    fn.argtypes = {args}
    fn.restype = {res}
    return fn

def _bytes():
    lib = _build.load("demo")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.{sym}.argtypes = [i] * 2
    lib.{sym}.restype = ll
'''

GOOD = dict(args="[ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, "
                 "ctypes.POINTER(ctypes.c_uint)]",
            res="ctypes.c_int", sym="demo_bytes")
KERN = "src/repro_torch/kernels/fake_kern.py"
EXTRA = {"src/repro_torch/csrc/demo.cu": CU}


def _kernel_lint(**over):
    code = BINDING.format(**{**GOOD, **over})
    return port_lint.analyze_source(code, KERN, [kernel_contract], extra=EXTRA)


def test_kernel_contract_clean_binding_passes():
    assert not _kernel_lint()


@pytest.mark.parametrize("over,rule", [
    (dict(args="[ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]"),
     "kernel-arity"),
    (dict(args="[ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, "
               "ctypes.c_void_p]"), "kernel-argtype"),
    (dict(args="[ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_double, "
               "ctypes.c_void_p]"), "kernel-argtype"),
    (dict(res="ctypes.c_longlong"), "kernel-restype"),
    (dict(sym="demo_missing"), "kernel-symbol"),
])
def test_kernel_contract_flags_a_seeded_disagreement(over, rule):
    assert {v.rule for v in _kernel_lint(**over)} == {rule}


def test_c_signatures_of_the_real_sources():
    sigs = kernel_contract.c_signatures(
        open(os.path.join(REPO, "src/repro_torch/csrc/xor_delta.cu")).read())
    assert sigs["xor_delta_launch"][1:] == (
        "i32", ("ptr", "ptr", "ptr", "ptr", "i64", "i32", "ptr"))
    assert kernel_contract.c_signatures(CU)["demo_bytes"][1:] == ("i64", ("i32", "i32"))


def test_every_real_launch_binding_is_checked():
    project = load_project(find_repo_root())
    names = {name for rel, text in project.extra.items()
             for name in kernel_contract.c_signatures(text)}
    bound = {b[2] for sf in project.under(*kernel_contract.SCOPE)
             for b in kernel_contract.bindings(sf) if b[1] == "argtypes"}
    for sym in ("bitpack_launch", "bytegroup_launch", "plane_launch", "unplane_launch",
                "histogram_launch", "xor_delta_launch", "huffdecode_selfsync_launch",
                "huffdecode_sync_launch", "huffdecode_chain_launch"):
        assert sym in names and sym in bound, sym
    assert not kernel_contract.check(project)


# ---------------------------------------------------------------------------
# The tree, and the package's imports
# ---------------------------------------------------------------------------

def test_repo_is_clean_strict():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--strict"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "zipnn-lint: clean" in r.stdout


def test_package_imports_only_the_stdlib():
    code = ("import sys\n"
            "import repro_torch.analysis, repro_torch.analysis.driver\n"
            "from repro_torch.analysis import base, container_spec, determinism, "
            "kernel_contract, knobs\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'ml_dtypes', 'repro'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
