"""Discovery by name: everything a cell needs is a file under
``portbench/``, found from the names in the cell's file.

- ``workloads/<cell>.json``: the cell (its configuration, its traffic, why,
  chips, and the limits of its numbers compared);
- ``configs/<config>.json``: the configuration (target, mover, dtype,
  source, assumed sizes);
- ``targets/<kind>.py``: how a target kind is made from the seed;
- ``traffic/<traffic>.json``: the call pattern the general driver runs;
- ``metrics/<metric>.py``: one per-layer metric's reader;
- ``roofline/<kernel>.py``: one kernel's operations and bytes.
"""

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def names(kind, suffix):
    """The names of the files of ``kind`` (a folder) ending in ``suffix``,
    sorted; files whose name starts with ``_`` are not entries."""
    return sorted(p.name[:-len(suffix)] for p in (ROOT / kind).glob(
        f"*{suffix}") if not p.name.startswith("_"))


def load_json(kind, name):
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise LookupError(f"no {kind} entry named {name!r} ({path})")
    return json.loads(path.read_text())


def module(kind, name):
    """The module ``<kind>/<name>.py``, loaded from its file."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {kind} entry named {name!r} ({path})")
    mod_name = f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(name):
    """The cell ``name`` with its configuration and traffic resolved."""
    cell = load_json("workloads", name)
    cell["name"] = name
    cell["config_spec"] = load_json("configs", cell["config"])
    cell["traffic_spec"] = load_json("traffic", cell["traffic"])
    return cell


def metric_modules():
    """{name: module} of every per-layer metric reader."""
    return {n: module("metrics", n) for n in names("metrics", ".py")}


def roofline(name):
    return module("roofline", name)
