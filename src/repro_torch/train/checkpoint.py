"""Checkpoints in the reference's on-disk format (``repro/train/
checkpoint.py``), so that a checkpoint moves between the two packages in
both directions:

* ``<dir>/step-%08d/`` holds ``manifest.json`` and one ``.npy`` per leaf,
  named by the reference's tree paths (``params/blocks/0/attn/wq``,
  ``opt/step``, ``opt/mu/...``) in its stacked layout
  (``models.params.params_to_numpy``), with a sha256 per array that a
  restore verifies before any weight is installed;
* writes go to ``<dir>/tmp-<step>-<pid>`` and then ``os.replace`` to
  ``step-N``, so a crash mid-save never corrupts the latest checkpoint;
  the newest ``keep`` checkpoints are retained;
* ``AsyncCheckpointer`` snapshots the tensors to host memory on the
  caller's thread and writes them from a background thread.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..distributed.optimizer import OptState
from ..kernels.common import DeviceLike, resolve_device
from ..models.params import model_defs, params_from_numpy, params_to_numpy

Tree = Any

MANIFEST = "manifest.json"


def _flatten(tree: Tree, prefix: str = "") -> List[Tuple[str, np.ndarray]]:
    """(path, leaf) pairs of nested dicts / tuples, as the reference names
    them: dict keys and sequence indices joined by ``/``."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _unflatten(arrays: Dict[str, np.ndarray]) -> Tree:
    """The inverse of ``_flatten``: nested dicts, where all-digit keys
    become tuples in index order."""
    root: Dict[str, Any] = {}
    for name, arr in arrays.items():
        *path, leaf = name.split("/")
        node = root
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = arr

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return tuple(fix(node[k]) for k in sorted(node, key=int))
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def host_trees(cfg: ModelConfig, params: Tree,
               opt_state: Optional[OptState] = None) -> Dict[str, Tree]:
    """The reference's trees of numpy arrays: ``params`` and, with an
    optimizer state, ``opt`` {step, mu, nu}."""
    trees = {"params": params_to_numpy(params, cfg)}
    if opt_state is not None:
        trees["opt"] = {
            "step": np.asarray(int(opt_state.step), dtype=np.int32),
            "mu": params_to_numpy(opt_state.mu, cfg),
            "nu": params_to_numpy(opt_state.nu, cfg)}
    return trees


def write_checkpoint(directory: str | Path, step: int,
                     trees: Dict[str, Tree], *,
                     extra: Optional[Dict[str, Any]] = None,
                     keep: int = 3) -> Path:
    """Atomic save of host trees (``host_trees``); returns the path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"tmp-{step}-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest: Dict[str, Any] = {"step": step, "arrays": {},
                                "extra": extra or {}, "time": time.time()}
    for prefix, tree in trees.items():
        for name, arr in _flatten(tree):
            fname = f"{prefix}__{name.replace('/', '__')}.npy"
            np.save(tmp / fname, arr)
            manifest["arrays"][f"{prefix}/{name}"] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": str(arr.dtype), "sha256": _sha256(arr)}
    (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
    final = directory / f"step-{step:08d}"
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    _retain(directory, keep)
    return final


def save_checkpoint(directory: str | Path, step: int, params: Tree,
                    cfg: ModelConfig, *,
                    opt_state: Optional[OptState] = None,
                    extra: Optional[Dict[str, Any]] = None,
                    keep: int = 3) -> Path:
    """Atomic synchronous save of a port tree (and optimizer state)."""
    return write_checkpoint(directory, step,
                            host_trees(cfg, params, opt_state), extra=extra,
                            keep=keep)


def _retain(directory: Path, keep: int) -> None:
    ckpts = sorted(d for d in directory.iterdir()
                   if d.is_dir() and d.name.startswith("step-"))
    for old in ckpts[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def latest_checkpoint(directory: str | Path) -> Optional[Path]:
    directory = Path(directory)
    if not directory.exists():
        return None
    ckpts = sorted(d for d in directory.iterdir()
                   if d.is_dir() and d.name.startswith("step-")
                   and (d / MANIFEST).exists())
    return ckpts[-1] if ckpts else None


def _conform(tree: Tree, defs: Tree, where: str) -> Tree:
    """``tree`` with ``defs``' leaves, shapes and dict order (the order
    ``init_params`` gives, so leaves line up with a fresh tree's)."""
    if isinstance(defs, dict):
        if set(tree) != set(defs):
            raise ValueError(f"checkpoint {where}: leaves {sorted(tree)}, "
                             f"config {sorted(defs)}")
        return {k: _conform(tree[k], d, f"{where}/{k}")
                for k, d in defs.items()}
    if isinstance(defs, list):
        return [_conform(t, d, f"{where}/{i}")
                for i, (t, d) in enumerate(zip(tree, defs))]
    if tuple(tree.shape) != tuple(defs.shape):
        raise ValueError(f"checkpoint {where}: shape {tuple(tree.shape)}, "
                         f"config {tuple(defs.shape)}")
    return tree


def restore_checkpoint(path: str | Path, cfg: ModelConfig, *,
                       device: DeviceLike = None, verify: bool = True
                       ) -> Tuple[int, Tree, Optional[OptState],
                                  Dict[str, Any]]:
    """(step, float32 params on ``device``, the optimizer state or None,
    extra) from a checkpoint written by either package.  Every array's
    sha256 is checked first (``IOError`` on a mismatch); leaves must
    match ``cfg``'s names and shapes, and come back in ``init_params``'
    order."""
    path = Path(path)
    dev = resolve_device(device)
    manifest = json.loads((path / MANIFEST).read_text())
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for key, meta in manifest["arrays"].items():
        arr = np.load(path / meta["file"])
        if verify and _sha256(arr) != meta["sha256"]:
            raise IOError(f"checksum mismatch for {key}")
        prefix, name = key.split("/", 1)
        groups.setdefault(prefix, {})[name] = arr
    trees = {k: _unflatten(v) for k, v in groups.items()}
    defs = model_defs(cfg)

    def to_port(tree: Tree, where: str) -> Tree:
        return _conform(params_from_numpy(tree, cfg, device=dev,
                                          dtype=torch.float32), defs, where)

    params = to_port(trees["params"], "params")
    opt = None
    if "opt" in trees:
        o = trees["opt"]
        opt = OptState(
            step=torch.as_tensor(np.asarray(o["step"]), dtype=torch.int32,
                                 device=dev),
            mu=to_port(o["mu"], "opt/mu"), nu=to_port(o["nu"], "opt/nu"))
    return int(manifest["step"]), params, opt, manifest.get("extra", {})


class AsyncCheckpointer:
    """Snapshot to host memory on the caller's thread, then write in a
    background thread.  ``snapshot_s`` and ``write_s`` time the last
    save's two halves."""

    def __init__(self, directory: str | Path, cfg: ModelConfig,
                 keep: int = 3):
        self.directory = Path(directory)
        self.cfg = cfg
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None
        self.snapshot_s = 0.0
        self.write_s = 0.0

    def save(self, step: int, params: Tree,
             opt_state: Optional[OptState] = None,
             extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        t0 = time.perf_counter()
        # Snapshot here (device -> host), so the train loop may update the
        # tensors in place right after.
        trees = host_trees(self.cfg, params, opt_state)
        self.snapshot_s = time.perf_counter() - t0

        def work():
            t1 = time.perf_counter()
            try:
                write_checkpoint(self.directory, step, trees, extra=extra,
                                 keep=self.keep)
            except BaseException as e:   # surfaced on the next wait()
                self.last_error = e
            self.write_s = time.perf_counter() - t1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
