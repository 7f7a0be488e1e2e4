"""Checkpointing: atomic, async-capable (port of ``repro/ckpt/
checkpoint.py:36-171``), in the JAX package's on-disk format, so either
package restores the other's checkpoint.

Layout:  <dir>/step_<k>/
            manifest.json     step, extra, leaf paths / dtypes / shapes
            arrays.npz        one entry per flattened tree path
         <dir>/LATEST         text file with the newest complete step dir

A tree is nested dicts whose leaves are tensors or numpy arrays; a leaf's
path joins its keys with "/" (the reference's ``_flatten`` of a dict
tree: "params/layers/attn/wq", "opt/m/embed", "opt/step"). bf16 leaves
are stored as raw ``uint16`` with the dtype tag ``"bfloat16"`` and read
back through ``torch.int16`` views, so neither side needs a numpy bf16.

* atomicity: writes go to ``.tmp-...`` then ``os.replace`` (an atomic
  POSIX rename), LATEST last, so a crash mid-save never corrupts the
  restore point;
* async: ``AsyncCheckpointer`` copies the tree to host memory
  synchronously and writes the files on a worker thread, overlapping the
  next training steps;
* placement: ``restore`` returns host tensors; the trainer places them on
  its device (the reference's ``reshard`` onto a mesh).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

SEP = "/"


def _flatten(tree, prefix=()) -> dict:
    """{path: leaf} in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    return {SEP.join(prefix): tree}


def _snapshot(tree) -> dict:
    """Every leaf copied to host memory now (a later in-place update of
    the tree does not reach it)."""
    return {k: (v.detach().to("cpu", copy=True)
                if isinstance(v, torch.Tensor) else np.array(v))
            for k, v in _flatten(tree).items()}


def save(tree, directory: str, step: int, *, extra: dict | None = None):
    """Synchronous atomic save. Returns the final step directory."""
    return _write(_snapshot(tree), directory, step, extra or {})


def _to_numpy(v):
    """(array to store, dtype tag)."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        v = v.numpy()
    return v, str(v.dtype)


def _write(host: dict, directory: str, step: int, extra: dict) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f".tmp-step_{step:08d}-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    conv = {}
    manifest = {"step": step, "extra": extra, "leaves": {}}
    for k, v in host.items():
        arr, tag = _to_numpy(v)
        manifest["leaves"][k] = {"dtype": tag, "shape": list(arr.shape)}
        conv[k] = arr
    np.savez(os.path.join(tmp, "arrays.npz"), **conv)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    with open(os.path.join(directory, ".LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
    os.replace(os.path.join(directory, ".LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> int | None:
    latest = os.path.join(directory, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(directory, name, "manifest.json")):
        return None
    return int(name.split("_")[-1])


def restore(directory: str, step: int | None = None):
    """Returns ({path: host tensor}, manifest)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for k, meta in manifest["leaves"].items():
            v = np.array(data[k], order="C")
            if meta["dtype"] == "bfloat16":
                out[k] = torch.from_numpy(v.view(np.int16)).view(
                    torch.bfloat16)
            else:
                out[k] = torch.from_numpy(v)
    return out, manifest


def unflatten_like(flat: dict, template):
    """Rebuild a tree with ``template``'s structure from path -> leaf."""
    missing = set(_flatten(template)) - set(flat)
    if missing:
        raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]}...")

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in node.items()}
        return flat[SEP.join(prefix)]

    return build(template, ())


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with training. ``save_async`` blocks only
    for the copy to host memory; the write happens on a daemon thread.
    ``wait`` joins it and raises what it raised."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save_async(self, tree, step: int, *, extra: dict | None = None):
        self.wait()
        host = _snapshot(tree)

        def work():
            try:
                _write(host, self.directory, step, extra or {})
                self._gc()
            except Exception as e:          # surfaced via last_error/wait
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(n.split("_")[-1]) for n in os.listdir(self.directory)
            if n.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
