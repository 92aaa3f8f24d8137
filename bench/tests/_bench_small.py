"""Shared by the benchmark's CPU tests: the paths, and a cell of
``BENCHMARK.json`` shrunk to the program's ``reduced()`` sizes and a few
sequences, which runs on the CPU in seconds."""

import dataclasses
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for _p in (BENCH, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from harness import cell as cells  # noqa: E402

SMALL_TRAFFIC = {"batch": 4, "context": 24, "output_tokens": 6, "warmup_steps": 2,
                 "trace_steps": 2, "sample_requests": 4}


def small_cell(workload: str, **traffic):
    """``workload`` at the reduced sizes of its program config (every
    width of the family kept in kind: GQA or MQA, norms, MLP, positions)."""
    from repro_torch.configs import get_config

    cell = cells.load(workload)
    reduced = dataclasses.asdict(get_config(cell.config["port_config"]).reduced())
    cell.config = dict(cell.config, config=reduced)
    cell.traffic = {**cell.traffic, **SMALL_TRAFFIC, **traffic}
    return cell
