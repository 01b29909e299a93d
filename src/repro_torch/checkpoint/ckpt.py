"""Atomic, async checkpointing in the reference's on-disk layout.

Layout (the reference's, ``src/repro/checkpoint/ckpt.py``):
    <dir>/step_000123/
        manifest.msgpack      # step, time, meta (bf16 leaves), extra, names
        arrays.npz            # flattened leaves, "/" in a name written "__"
    <dir>/LATEST              # atomic pointer, written last

So either runtime restores the other's checkpoints. bf16 leaves are stored
as their bits in ``uint16`` with ``meta[name] = {"dtype": "bfloat16"}`` and
read back by a view, never through float32. The manifest is written by
``_msgpack``, this package's own MessagePack subset, with the bytes that
``msgpack.packb`` gives.

Guarantees:
* atomic commit — a step's directory is renamed into place only after a full
  write, and LATEST after it, so a crash mid-write never corrupts the
  restore path;
* async — ``save_async`` copies every leaf to host memory (the snapshot; the
  trainer updates its tensors in place, so a snapshot that shared their
  memory would be written while the next step overwrites it), then writes on
  a background thread while training continues;
* restore by name onto ``device``. The reference's ``shardings=`` (a
  placement for each leaf over a device mesh) is ``device=`` here, one
  device for every leaf, until the port places tensors over a mesh.
"""
from __future__ import annotations

import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import _msgpack

def _flatten(tree, prefix=""):
    """``{"a/b": leaf}`` in sorted-key order. A node is anything with
    ``keys()`` (a dict, an ``nn.ParameterDict``); the rest are leaves."""
    out = {}
    if hasattr(tree, "keys"):
        for k in sorted(tree.keys()):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _host_copy(leaf) -> np.ndarray:
    """A host array that shares no memory with ``leaf``: bf16 as its bits in
    ``uint16``. A copy from the card is complete when this returns (a
    synchronous device-to-host copy)."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf, copy=True)
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16)
    return t.to("cpu", copy=True).numpy()


def _snapshot(tree) -> tuple[dict, dict, int]:
    """(name -> host array, meta, bytes) of a tree's leaves."""
    host, meta = {}, {}
    for name, leaf in _flatten(tree).items():
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            meta[name] = {"dtype": "bfloat16"}
        host[name] = _host_copy(leaf)
    return host, meta, sum(a.nbytes for a in host.values())


def _write(ckpt_dir: str, step: int, host: dict, meta: dict, extra: dict | None) -> str:
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:09d}_{os.getpid()}")
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(_msgpack.packb({
            "step": step,
            "time": time.time(),
            "meta": meta,
            "extra": extra or {},
            "names": list(host),
        }))
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k.replace("/", "__"): v for k, v in host.items()})
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    latest_tmp = os.path.join(ckpt_dir, ".LATEST_tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Synchronous atomic save. Returns the committed directory."""
    host, meta, _ = _snapshot(tree)
    return _write(ckpt_dir, step, host, meta, extra)


class AsyncCheckpointer:
    """Snapshot-on-call, write-in-background. One in-flight save at a time
    (a second save waits — backpressure instead of unbounded host memory).

    ``saves`` records each save: its step, bytes, the seconds ``save_async``
    held its caller for the snapshot (``snapshot_s``) and, once the write
    has finished, the background write's seconds (``write_s``)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None
        self.saves: list[dict] = []

    def save_async(self, step: int, tree, extra: dict | None = None):
        self.wait()
        t0 = time.perf_counter()
        host, meta, nbytes = _snapshot(tree)
        record = {"step": step, "bytes": nbytes, "snapshot_s": time.perf_counter() - t0,
                  "write_s": None}
        self.saves.append(record)

        def _run():
            try:
                t1 = time.perf_counter()
                _write(self.dir, step, host, meta, extra)
                record["write_s"] = time.perf_counter() - t1
                self._gc()
            except Exception as e:  # noqa: BLE001 — raised by the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, step: int | None = None, device=None):
    """Load a checkpoint, every leaf a tensor on ``device`` (default: the
    card) with the dtype and bits it was saved with; bf16 leaves come back
    as ``torch.bfloat16``. Returns (step, tree, extra)."""
    device = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        manifest = _msgpack.unpackb(f.read())
    flat = {}
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for name in manifest["names"]:
            arr = data[name.replace("/", "__")]
            if manifest["meta"].get(name, {}).get("dtype") == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            flat[name] = t.to(device)
    return manifest["step"], _unflatten(flat), manifest.get("extra", {})
