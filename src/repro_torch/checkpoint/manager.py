"""Fault-tolerant checkpointing: atomic, async, integrity-checked.

The port of the reference's ``checkpoint/manager.py``. A tree is nested
dicts (or lists) of tensors, such as ``{"params": {name: tensor}, "opt":
state}``; its leaves are stored by path, ``/``-joined.

Layout:  <dir>/step_<N>/
             shard_<k>.npz        the flattened leaves (bfloat16 as its bits)
             MANIFEST.json        keys + shapes + dtypes + per-file sha256
         <dir>/LATEST             name of the newest *complete* checkpoint

Guarantees:
* **atomic**: written to ``step_<N>.tmp`` then renamed — a crash mid-write
  never corrupts the visible checkpoint;
* **integrity**: restore verifies the manifest's hashes; a damaged
  checkpoint is skipped and the previous one loads instead
  (``restore_latest`` walks backwards);
* **async**: ``save_async`` copies every leaf to host memory synchronously
  and writes in a daemon thread — training continues;
* **logical**: the leaves are stored whole; ``restore`` puts each on the
  device of the matching leaf of ``like`` (or on ``device``).
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

SEP = "/"


def _leaves(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}{SEP}")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, f"{prefix}{i}{SEP}")
    else:
        yield prefix[:-1], tree


def _rebuild(like: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {key: _rebuild(sub, leaves, f"{prefix}{key}{SEP}") for key, sub in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(sub, leaves, f"{prefix}{i}{SEP}")
                          for i, sub in enumerate(like))
    return leaves[prefix[:-1]]


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A leaf's host copy as numpy (a copy even of a CPU tensor, so that a
    later in-place update cannot reach a pending write): bfloat16 as its
    16 bits (int16)."""
    t = t.detach().to("cpu", copy=True)
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, order="C"))
    return t.view(torch.bfloat16) if dtype == str(torch.bfloat16) else t


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def _snapshot(self, tree: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
        flat, dtypes = {}, {}
        for key, leaf in _leaves(tree):
            leaf = torch.as_tensor(leaf)
            flat[key], dtypes[key] = _to_host(leaf), str(leaf.dtype)
        return flat, dtypes

    def save(self, step: int, tree: Any, shards: int = 1):
        """Synchronous atomic save."""
        self.wait()  # never race a pending async write
        self._write(step, *self._snapshot(tree), shards)

    def save_async(self, step: int, tree: Any, shards: int = 1):
        """Copy every leaf to the host now, write in the background."""
        self.wait()
        flat, dtypes = self._snapshot(tree)  # the device -> host copies happen here
        self._thread = threading.Thread(
            target=self._write, args=(step, flat, dtypes, shards), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: Dict[str, np.ndarray], dtypes: Dict[str, str],
               shards: int):
        name = f"step_{step:08d}"
        tmp = self.dir / (name + ".tmp")
        final = self.dir / name
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        keys = sorted(flat)
        shard_files: List[str] = []
        manifest: Dict[str, Any] = {
            "step": step,
            "keys": keys,
            "shapes": {k: list(flat[k].shape) for k in keys},
            "dtypes": {k: dtypes[k] for k in keys},
            "time": time.time(),
        }
        for sh in range(shards):
            part = {k: flat[k] for i, k in enumerate(keys) if i % shards == sh}
            fn = tmp / f"shard_{sh}.npz"
            np.savez(fn, **{k.replace(SEP, "|"): v for k, v in part.items()})
            shard_files.append(fn.name)
        manifest["files"] = {f: _sha256(tmp / f) for f in shard_files}
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        (self.dir / "LATEST.tmp").write_text(name)
        os.replace(self.dir / "LATEST.tmp", self.dir / "LATEST")
        self._gc()

    def _gc(self):
        ckpts = sorted(d for d in self.dir.iterdir() if d.is_dir() and d.name.startswith("step_")
                       and not d.name.endswith(".tmp"))
        for d in ckpts[: -self.keep]:
            shutil.rmtree(d, ignore_errors=True)

    # ------------------------------------------------------------------
    def available_steps(self) -> List[int]:
        out = []
        for d in sorted(self.dir.iterdir()):
            if d.is_dir() and d.name.startswith("step_") and not d.name.endswith(".tmp"):
                out.append(int(d.name.split("_")[1]))
        return out

    def _verify(self, d: Path) -> bool:
        mf = d / "MANIFEST.json"
        if not mf.exists():
            return False
        try:
            manifest = json.loads(mf.read_text())
            for f, digest in manifest["files"].items():
                if _sha256(d / f) != digest:
                    return False
            return True
        except Exception:
            return False

    def restore(self, step: int, like: Any, device: Optional[str] = None) -> Any:
        """The tree saved at ``step``, in ``like``'s structure: each leaf in
        its ``like`` leaf's dtype, on ``device`` (``None``: the ``like``
        leaf's device). Raises ``IOError`` for a damaged checkpoint and
        ``ValueError`` for a shape that differs from ``like``'s."""
        d = self.dir / f"step_{step:08d}"
        if not self._verify(d):
            raise IOError(f"checkpoint {d} failed integrity check")
        manifest = json.loads((d / "MANIFEST.json").read_text())
        flat: Dict[str, torch.Tensor] = {}
        for f in manifest["files"]:
            with np.load(d / f) as z:
                for k in z.files:
                    key = k.replace("|", SEP)
                    flat[key] = _from_host(z[k], manifest["dtypes"][key])
        out = {}
        for key, leaf in _leaves(like):
            leaf = torch.as_tensor(leaf)
            t = flat[key]
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt {tuple(t.shape)} vs "
                                 f"{tuple(leaf.shape)}")
            out[key] = t.to(dtype=leaf.dtype, device=device or leaf.device)
        return _rebuild(like, out)

    def restore_latest(self, like: Any, device: Optional[str] = None
                       ) -> Tuple[Optional[int], Any]:
        """Walk back from the newest checkpoint until one verifies."""
        for step in sorted(self.available_steps(), reverse=True):
            try:
                return step, self.restore(step, like, device)
            except Exception:
                continue
        return None, like
