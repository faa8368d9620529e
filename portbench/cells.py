"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (``workloads[i]``) names a configuration, whose file lies where the
``configs`` entry says, and a traffic mix, read from
``traffic/<traffic>.json`` beside this module.  The per-layer metrics of a
cell are the ``per_layer`` entries whose ``workloads`` list it (or that
have no such list), each read by ``metrics/<name>.py``; the end-to-end
metrics are the ``end_to_end`` entries, each read by ``metrics/<name>.py``
too.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List

from portbench.work import padded_vocab

__all__ = ["Cell", "HERE", "ROOT", "load_cell", "load_config", "port_arch"]

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    config_file: pathlib.Path


def _in_cell(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell named ``workload`` in ``root/BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config_file = root / entry["file"]
    config = json.loads(config_file.read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _in_cell(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _in_cell(m, workload)],
        config_file=config_file)


def load_config(name: str) -> Dict:
    """The configuration file ``configs/<name>.json`` beside this module,
    whether or not a cell of ``BENCHMARK.json`` runs it."""
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def port_arch(config: Dict):
    """The program's ``ArchConfig`` for a configuration file: the port's
    registered architecture ``config["port"]["arch"]`` with every field of
    ``config["port"]["fields"]`` set from the file's published key (the
    vocabulary padded as the file says)."""
    from repro_torch.configs import get_arch

    port = config["port"]
    values = {field: (padded_vocab(config) if field == "vocab_size"
                      else config[key])
              for field, key in port["fields"].items()}
    return dataclasses.replace(get_arch(port["arch"]), **values)
