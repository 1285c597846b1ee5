"""``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each is a JSON file found by its name: ``configs/<config>.json`` and
``traffic/<traffic>.json`` beside this file.  Every metric is a reader
``metrics/<name>.py`` (``benchmark/metrics/__init__.py``).  Adding a cell,
a configuration, a traffic mix or a metric adds files and entries; no file
here changes.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _data(base: Path, kind: str, name: str) -> dict:
    if not NAME_RE.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    with open(Path(base) / kind / f"{name}.json") as f:
        return json.load(f)


def cell(bench: dict, name: str, base: Path = HERE) -> dict:
    """The cell ``name``: its ``BENCHMARK.json`` entry with the files of its
    configuration (``config_data``) and traffic mix (``traffic_data``), and
    the metrics it reports (``end_to_end``, ``per_layer``)."""
    w = dict(_named(bench["workloads"], name, "workload"))
    w["config_data"] = _data(base, "configs", w["config"])
    w["traffic_data"] = _data(base, "traffic", w["traffic"])
    w["base"] = str(base)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    w["end_to_end"] = e2e
    w["per_layer"] = [m for m in bench["per_layer"]
                      if ((name in m["workloads"]) if "workloads" in m else (m["moves"] in moved))]
    return w
