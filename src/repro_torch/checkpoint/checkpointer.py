"""Atomic, device-agnostic checkpointing with keep-K retention.

The reference's design (``src/repro/checkpoint/checkpointer.py``):

  * every leaf is saved as a full logical array, one raw ``.npy`` file a
    leaf (no pickle, no code run on restore), named by its path in the
    tree (:mod:`repro_torch.tree`; ``"0/stack/3/mixer/wq"``);
  * writes go to ``step_XXXXXXXX.tmp/`` then ``os.rename`` to
    ``step_XXXXXXXX/``: a reader never sees a torn checkpoint;
  * ``manifest.json`` records each leaf's file, shape, dtype and crc32;
    restore checks them before building anything;
  * ``keep`` retention bounds disk use: the newest K checkpoints survive.

bf16 leaves are stored as their uint16 bits under the manifest dtype
``"bfloat16"`` (numpy has no bf16, and the card's machine has no
``ml_dtypes``), as :mod:`repro_torch.convert` carries them; the crc32 of
those bytes equals the reference's for the same values.  Restore puts each
leaf on ``device`` (the reference's ``shardings=``), or on the template
leaf's device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree

__all__ = ["Checkpointer", "save_pytree", "restore_pytree"]

_STEP_RE = re.compile(r"^step_(\d{8})$")
_BF16 = "bfloat16"


@dataclasses.dataclass(frozen=True)
class _Host:
    """A leaf's values copied to the host (bf16 as uint16 bits), with the
    dtype name the manifest records."""

    arr: np.ndarray
    dtype: str


def _host(leaf) -> _Host:
    if isinstance(leaf, _Host):
        return leaf
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return _Host(t.view(torch.int16).numpy().view(np.uint16), _BF16)
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True)
    return _Host(arr, str(arr.dtype))


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(arr.tobytes()) & 0xFFFFFFFF


def save_pytree(tree_, directory: Path) -> Dict[str, Any]:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    manifest: Dict[str, Any] = {"leaves": {}}
    for key, leaf in tree.leaves_with_paths(tree_):
        host = _host(leaf)
        arr = host.arr
        fname = key.replace("/", "__") + ".npy"
        np.save(directory / fname, arr, allow_pickle=False)
        manifest["leaves"][key] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": host.dtype,
            "crc32": _crc(arr),
        }
    (directory / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return manifest


def restore_pytree(template, directory: Path, *, device=None):
    """Restore into the structure of ``template`` (its values ignored).
    Each leaf lands on ``device``, or, without one, on the template leaf's
    device (the CPU for a leaf that is no tensor)."""
    directory = Path(directory)
    manifest = json.loads((directory / "manifest.json").read_text())
    out = []
    for key, leaf in tree.leaves_with_paths(template):
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(directory / meta["file"], allow_pickle=False)
        stored = "uint16" if meta["dtype"] == _BF16 else meta["dtype"]
        if list(arr.shape) != meta["shape"] or str(arr.dtype) != stored:
            raise ValueError(f"manifest mismatch for {key!r}")
        if _crc(arr) != meta["crc32"]:
            raise ValueError(f"checksum mismatch for {key!r} — corrupt checkpoint")
        if meta["dtype"] == _BF16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        where = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        out.append(t.to(where))
    return tree.unflatten(template, out)


@dataclasses.dataclass
class Checkpointer:
    root: Path
    keep: int = 3

    def __post_init__(self):
        self.root = Path(self.root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._pending: Optional[threading.Thread] = None  # in-flight save

    # ---- write -----------------------------------------------------------
    def save(self, step: int, tree_) -> Path:
        final = self.root / f"step_{step:08d}"
        tmp = self.root / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        save_pytree(tree_, tmp)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def save_async(self, step: int, tree_) -> None:
        """Snapshot to host memory now, write in a background thread.

        The caller blocks only for the device-to-host copy (and for any
        previous in-flight write: one writer, ordered checkpoints).  The
        snapshot is a copy, so the caller may update its tensors in place
        as soon as this returns.  Durability is ``save``'s: write-temp,
        then an atomic rename."""
        self.wait()
        snapshot = tree.tree_map(_host, tree_)
        t = threading.Thread(target=self.save, args=(step, snapshot),
                             daemon=True)
        t.start()
        self._pending = t

    def wait(self) -> None:
        """Block until any in-flight async save has published."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    # ---- read ------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for p in self.root.iterdir():
            m = _STEP_RE.match(p.name)
            if m and p.is_dir():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template, step: Optional[int] = None, *, device=None):
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return restore_pytree(template, self.root / f"step_{step:08d}",
                              device=device), step

    # ---- retention ---------------------------------------------------------
    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)
