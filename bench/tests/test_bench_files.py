"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from _bench_small import BENCH, ROOT
from harness import cell as cells

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/") for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    entries = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names)), group
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in SPEC["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_entry_keys_and_lines():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])


def test_every_cell_config_mix_mode_and_metric_has_its_file():
    configs = {c["name"]: c for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    used = set()
    for w in SPEC["workloads"]:
        conf = configs[w["config"]]
        used.add(conf["name"])
        assert (ROOT / conf["file"]).is_file() and conf["file"].startswith("bench/")
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "modes" / f"{mix['mode']}.py").is_file()
        family = json.loads((ROOT / conf["file"]).read_text())["config"]["family"]
        ref = cells.load_module(BENCH / "reference" / f"{family}.py")
        for fn in ("param_shapes", "cache_shapes", "logits", "decode_flops"):
            assert callable(getattr(ref, fn, None)), (family, fn)
        assert (BENCH / "checks" / f"{w['name']}.json").is_file()
    assert used == set(configs)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_pairs_chips_and_cell_reports():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(CELLS) // 4)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert layers.setdefault(m["layer"], m["layer"]) == m["layer"]
    for w in CELLS:
        names = {m["name"] for m in SPEC["end_to_end"] if w in m.get("workloads", CELLS)}
        assert "setup_s" in names and len(names) >= 2
        assert any(w in m.get("workloads", CELLS) and m["moves"] in names
                   for m in SPEC["per_layer"])


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_holds_its_numbers_and_cuts(conf):
    """Every number of the program's config is in the file, ``reduced``
    names each key cut from the source, and no width is cut."""
    import dataclasses

    from repro_torch.configs import get_config

    doc = json.loads((ROOT / conf["file"]).read_text())
    assert doc["name"] == conf["name"] and doc["source"] == conf["source"]
    fields = {f.name for f in dataclasses.fields(get_config(doc["port_config"]))}
    assert set(doc["config"]) == fields
    assert sorted(doc["reduced"]) == sorted(conf["reduced"])
    widths = re.compile(r"(_dim|_rank|^d_|_ff$|^head|^n_heads|^n_kv_heads|experts_per_token)")
    assert not [k for k in conf["reduced"] if widths.search(k)]
    for k, cut in doc["reduced"].items():
        assert doc["config"][k] == cut["run"] and cut["run"] != cut["published"]
    assert "assumed" in doc and "deployment" in doc
