"""The four examples on the port (``examples/torch_*.py``) run on the CPU
with ``device="cpu"``, where each kernel wrapper runs its plain version:

* quickstart: its own checks (bit-exact round trips, the same bytes
  through ``ZipNNSession``, no payload upload a ring step), and a plan for
  every section whose launches it reports (the card's counts; 0 here);
* the hub transfer model and the gradient exchange compress BF16 to about
  two thirds;
* the training demo trains, resumes from its ZipNN checkpoint and serves
  from it, each phase a ``repro_torch.launch`` process;
* none of them imports ``jax``, ``ml_dtypes`` or ``repro``.
"""

import ast
import glob
import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "torch_*.py")))


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """Each example on one CPU thread, here and in the processes it starts
    (the other test files' workers share the cores; some time a codec),
    the thread count restored after."""
    import torch

    before = torch.get_num_threads()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "examples",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_four_examples_exist():
    assert [os.path.basename(p) for p in EXAMPLES] == [
        "torch_decentralized_grad_sync.py", "torch_hub_transfer_sim.py",
        "torch_quickstart.py", "torch_train_checkpoint_demo.py"]


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_examples_import_no_jax_or_reference(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in ("jax", "ml_dtypes", "repro"), (path, n)


def test_quickstart_on_cpu():
    out = _load("torch_quickstart").main("cpu")
    assert out["payload_uploads"] == 0
    assert out["ratio_pct"] < 70
    assert set(out["plan"]) == set(out["launches"]) == {"encode", "decode", "ring"}
    # the ring's plan is the feeds' launch counts, one set a step
    assert all(n > 0 for n in out["plan"]["ring"].values())
    # on the CPU no kernel launches: the wrappers ran their plain versions
    assert all(n == 0 for sec in out["launches"].values() for n in sec.values())


def test_hub_transfer_on_cpu():
    out = _load("torch_hub_transfer_sim").main("cpu")
    assert 60 < out["ratio_pct"] < 70
    assert max(out["speedup"].values()) > 1


def test_grad_sync_on_cpu():
    out = _load("torch_decentralized_grad_sync").main("cpu")
    assert 55 < out["ratio_pct"] < 75


def test_train_checkpoint_demo_on_cpu():
    out = _load("torch_train_checkpoint_demo").main("cpu", steps=6)
    assert out["checkpoint_entries"], "the demo saved no checkpoint"
