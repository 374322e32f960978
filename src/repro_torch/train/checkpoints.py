"""Checkpointing: atomic, hash-verified, async.  Port of
``repro.train.checkpoints``, in the JAX package's on-disk format byte for
byte, so a checkpoint written by either package restores in the other.

Layout of one checkpoint::

    <dir>/ckpt_0000123/
        MANIFEST.json     # step, user metadata, per leaf: file, shape,
                          # dtype, sha1 of the bytes
        <leaf-path>.npy   # one file per leaf ("a/b/c" -> a__b__c.npy)

Writes go to ``ckpt_0000123.tmp`` and are renamed only after every leaf and
the manifest hit disk, so a crash mid-save leaves the previous checkpoint
intact.  ``save`` copies every leaf to host memory before it returns or
starts its writer thread (the JAX package's ``jax.device_get``), so a
step that updates the state in place afterwards cannot reach the files.
A leaf whose dtype numpy cannot save (``bfloat16``) raises: it is never
cast.

One difference from the JAX package: its manager never records an error
of the background writer (``self._error`` stays ``None``), so a failed
``save(block=False)`` is silent and ``wait`` returns.  The port records
it, and ``wait`` (also the next ``save``) raises it.

``restore(device=...)`` returns tensors there, and without a device
numpy arrays, as the JAX package does without shardings.

Over a mesh (``shardings=``, a tree of ``sharding.Sharding`` matching the
state, e.g. ``train.step.state_shardings``): ``save`` gathers every leaf
(a collective: every rank calls it), rank 0 writes the global arrays in
the format above, byte for byte, and the other ranks wait at a barrier
(after the write; with ``block=False`` in the next ``wait``); so a
checkpoint of any mesh, of either package, restores in the other.
``restore(shardings=...)`` gives each rank its blocks of the global
arrays, on whatever mesh is alive: save at 4 ranks, restore at 2
(elastic restore).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import threading
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

_CKPT_RE = re.compile(r"^ckpt_(\d+)$")


def _is_node(x) -> bool:
    return isinstance(x, (Mapping, torch.nn.ParameterDict))


def _flatten(tree) -> dict:
    """{'a/b/0': leaf} with deterministic, filesystem-safe keys."""
    flat = {}

    def walk(node, path):
        if _is_node(node):
            for k in sorted(node.keys()):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            flat["/".join(path)] = node

    walk(tree, ())
    return flat


def _unflatten_into(template, flat: dict):
    """Rebuild a tree shaped like ``template`` from the flat dict (inner
    nodes as dicts, lists and tuples)."""
    def walk(node, path):
        if _is_node(node):
            return {k: walk(node[k], path + (str(k),)) for k in node.keys()}
        if isinstance(node, (list, tuple)):
            t = [walk(v, path + (str(i),)) for i, v in enumerate(node)]
            return type(node)(t)
        return flat["/".join(path)]

    return walk(template, ())


def _nest(flat: dict):
    """Rebuild a pure-dict tree from flat 'a/b/c' keys."""
    root: dict = {}
    for key, val in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _sha1(arr: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(arr).view(np.uint8)).hexdigest()


def _to_host(key: str, leaf) -> np.ndarray:
    """A copy of ``leaf`` in host memory, as numpy."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"checkpoint leaf {key!r} is bfloat16, which "
                            "numpy cannot save; cast it explicitly before "
                            "saving")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    verify_hashes: bool = True

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: the mesh whose ranks wait for rank 0's pending write
        self._mesh = None

    # -- enumeration ---------------------------------------------------------

    def steps(self) -> list:
        out = []
        for name in os.listdir(self.directory):
            m = _CKPT_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "MANIFEST.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _path(self, step: int, tmp: bool = False) -> str:
        return os.path.join(self.directory,
                            f"ckpt_{step:07d}" + (".tmp" if tmp else ""))

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree, metadata: Optional[dict] = None,
             block: bool = True, shardings=None):
        """Write checkpoint for ``step``. With ``block=False`` the disk I/O
        runs on a background thread (the device->host copy still happens
        here, so the step's tensors are snapshotted consistently).
        ``shardings``: ``tree`` holds this rank's blocks; every rank calls
        ``save``, rank 0 writes the gathered arrays."""
        self.wait()
        flat = _flatten(tree)
        mesh = None
        if shardings is not None:
            sh = _flatten(shardings)
            mesh = next(iter(sh.values())).mesh
            if mesh.group is None:
                mesh = None
        if mesh is None:
            host = {k: _to_host(k, v) for k, v in flat.items()}
        else:
            # leaf by leaf, to rank 0's host memory alone
            host = {}
            for k, v in flat.items():
                if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
                    _to_host(k, v)                  # raises, on every rank
                g = sh[k].gather_host(v)
                if mesh.rank == 0:
                    host[k] = g
            self._mesh = mesh
            if mesh.rank != 0:
                if block:
                    self.wait()
                return

        def write():
            tmp = self._path(step, tmp=True)
            final = self._path(step)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "metadata": metadata or {},
                        "leaves": {}}
            for key, arr in host.items():
                fname = key.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"][key] = {
                    "file": fname, "shape": list(arr.shape),
                    "dtype": str(arr.dtype), "sha1": _sha1(arr)}
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)        # the atomic commit point
            self._gc()

        if block:
            try:
                write()
            finally:
                self.wait()
            return

        def background():
            try:
                write()
            except BaseException as e:   # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=background, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the background writer; raise what it raised, once.  Over a
        mesh every rank waits here until rank 0's write is on disk."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            dist.barrier(group=mesh.group)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # -- restore -------------------------------------------------------------

    def restore(self, step: Optional[int] = None, template=None,
                shardings=None, device=None) -> tuple[int, Any]:
        """Load a checkpoint (the latest without ``step``).  ``template``
        (any tree of the right structure) rebuilds nesting; ``shardings``
        (a tree of ``sharding.Sharding``): every leaf this rank's block;
        ``device``: every leaf a tensor there, else numpy arrays."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._path(step)
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        flat = {}
        for key, info in manifest["leaves"].items():
            arr = np.load(os.path.join(path, info["file"]))
            if self.verify_hashes and _sha1(arr) != info["sha1"]:
                raise IOError(f"checkpoint corruption in {key} "
                              f"(sha1 mismatch) at {path}")
            flat[key] = arr
        if shardings is not None:
            sh = _flatten(shardings)
            flat = {k: np.array(sh[k].local(a))
                    for k, a in flat.items()}
        if device is not None:
            flat = {k: torch.from_numpy(a).to(device)
                    for k, a in flat.items()}
        if template is None:
            return step, _nest(flat)
        return step, _unflatten_into(template, flat)

    def metadata(self, step: Optional[int] = None) -> dict:
        if step is None:
            step = self.latest_step()
        with open(os.path.join(self._path(step), "MANIFEST.json")) as f:
            return json.load(f)["metadata"]
