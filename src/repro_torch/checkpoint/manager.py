"""Checkpointing: atomic, optionally asynchronous, keep-N.

Port of ``repro.checkpoint.manager.CheckpointManager`` in the port's own
format (``restore_reference`` reads the reference's ``.npy`` directories:
``manifest.json`` and ``arrays/<id>.npy``, with numpy; ``convert.py``
turns what it reads into the port's parameters and optimizer state)::

    <root>/step_00000123/
        tensors.pt       # torch.save of {leaf path: CPU tensor}
        manifest.json    # step, leaf paths with dtype and shape, extras
    <root>/LATEST        # name of the newest complete step directory

* Atomic: a step is written to ``step_X.tmp`` and renamed; ``LATEST`` is
  replaced by rename.  A writer stopped midway leaves the previous
  checkpoint intact.
* Async: ``save(..., blocking=False)`` copies the tree to host memory and
  writes on a thread; a failed write re-raises at the next
  ``wait``/``save``.
* Keep-N garbage collection of older steps.
* A tree is nested dicts, lists and tuples (NamedTuples included) of
  tensors and Python numbers; ``restore`` rebuilds the template's
  structure with each tensor on the template leaf's device and dtype (a
  ``None`` leaf takes the saved tensor as it was written, on the CPU).
* Extras (JSON) carry the data-pipeline cursor and the active coreset, so
  a restart resumes the exact stream.
* Sharded trees: a DTensor leaf is saved whole (``full_tensor()``, a
  gather every rank joins) and rank 0 writes.  ``restore(...,
  shardings=)`` places each restored tensor by its layout, so a tree saved
  on one mesh restores onto another (the reference's elastic restore).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

__all__ = ["CheckpointManager", "flatten", "unflatten"]


def _gathered(v):
    """A DTensor whole on every rank, else ``v``."""
    from torch.distributed.tensor import DTensor

    return v.full_tensor() if isinstance(v, DTensor) else v


def _is_dtensor(v) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(v, DTensor)


def _writer() -> bool:
    """Rank 0 of an initialised process group writes; one process always."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _placed(tree: Any, template: Any, shardings: Any) -> Any:
    """``tree`` with each tensor distributed by its layout: the
    ``shardings`` leaf at its place, a ``(DeviceMesh, placements)`` pair,
    or else the template leaf's own when that is a DTensor.  Every rank
    holds the whole tensor (each read the file), so placing moves no data."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(tree, dict):
        sh = shardings if isinstance(shardings, dict) else {}
        return {k: _placed(v, template[k], sh.get(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Tensor):
        sh = shardings if isinstance(shardings, (list, tuple)) else [None] * len(tree)
        vals = [_placed(v, t, s) for v, t, s in zip(tree, template, sh)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    if not isinstance(tree, torch.Tensor):
        return tree
    if shardings is None and isinstance(template, DTensor):
        shardings = (template.device_mesh, template.placements)
    if shardings is None:
        return tree
    mesh, placements = shardings
    return distribute_tensor(tree, mesh, placements, src_data_rank=None)


def flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """{'a/b/0': leaf} for nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix or "leaf": tree}
    out: dict[str, Any] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(template: Any, flat: dict[str, Any], prefix: str = "") -> Any:
    """Rebuild ``template``'s structure from ``flatten`` output."""
    if isinstance(template, dict):
        return {k: unflatten(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        vals = [unflatten(v, flat, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(template)]
        if hasattr(template, "_fields"):  # NamedTuple
            return type(template)(*vals)
        return type(template)(vals)
    value = flat[prefix or "leaf"]
    if template is None:
        return value
    if isinstance(template, torch.Tensor):
        return value.to(device=template.device, dtype=template.dtype)
    return type(template)(value.item())


def _nest(flat: dict[str, Any]) -> Any:
    """{'a/0/b': leaf} → nested dicts, a dict keyed 0…n−1 a list; a key
    of a NamedTuple field ('.step': JAX's attribute path) loses its dot."""
    tree: dict = {}
    for path, leaf in flat.items():
        node, parts = tree, [p.lstrip(".") for p in path.split("/")]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def lists(t):
        if not isinstance(t, dict):
            return t
        t = {k: lists(v) for k, v in t.items()}
        if t and all(k.isdigit() for k in t) and sorted(map(int, t)) == list(range(len(t))):
            return [t[str(i)] for i in range(len(t))]
        return t

    return lists(tree)


def _read_reference(step_dir: str) -> tuple[Any, dict]:
    """A reference checkpoint's step directory → (its tree, nested dicts
    and lists of numpy arrays; its extras).  Reads the reference's
    ``manifest.json`` and one ``arrays/<id>.npy`` a leaf with numpy alone;
    a leaf the reference left out of the tree (``None``, an empty tuple)
    is not there."""
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for leaf in manifest["leaves"]:
        arr = np.load(os.path.join(step_dir, "arrays", leaf["file"]))
        if list(arr.shape) != list(leaf["shape"]) or str(arr.dtype) != leaf["dtype"]:
            raise ValueError(f"{step_dir}: {leaf['path']} holds {arr.dtype}{list(arr.shape)}, "
                             f"the manifest says {leaf['dtype']}{leaf['shape']}")
        flat[leaf["path"]] = arr
    return _nest(flat), manifest.get("extras", {})


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, extras: dict | None = None,
             blocking: bool = True) -> None:
        """Snapshot ``tree`` + JSON-able ``extras`` as step ``step``.  A
        tree with DTensor leaves is saved by every rank of their group
        together: each leaf is gathered whole, rank 0 writes, and a
        blocking save ends in a barrier, so any rank may restore next."""
        flat = flatten(tree)
        sharded = any(map(_is_dtensor, flat.values()))
        host = {
            k: (_gathered(v).detach().to("cpu", copy=True) if isinstance(v, torch.Tensor)
                else torch.tensor(v))
            for k, v in flat.items()
        }
        if sharded and not _writer():
            if blocking:
                torch.distributed.barrier()
            return

        def write():
            try:
                final = os.path.join(self.root, f"step_{step:08d}")
                tmp = final + ".tmp"
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                torch.save(host, os.path.join(tmp, "tensors.pt"))
                manifest = {
                    "step": step,
                    "leaves": [{"path": k, "dtype": str(v.dtype), "shape": list(v.shape)}
                               for k, v in host.items()],
                    "extras": extras or {},
                }
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                ptr_tmp = os.path.join(self.root, "LATEST.tmp")
                with open(ptr_tmp, "w") as f:
                    f.write(os.path.basename(final))
                os.replace(ptr_tmp, os.path.join(self.root, "LATEST"))
                self._gc()
            except BaseException as e:  # noqa: BLE001 — re-raised at wait()
                self._error = e

        self.wait()
        if blocking:
            write()
            if sharded:
                torch.distributed.barrier()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _gc(self) -> None:
        steps = sorted(
            d for d in os.listdir(self.root)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def latest_step(self) -> int | None:
        ptr = os.path.join(self.root, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            name = f.read().strip()
        if not os.path.exists(os.path.join(self.root, name, "manifest.json")):
            return None
        return int(name.split("_")[1])

    def _step_dir(self, step: int | None) -> str:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        return os.path.join(self.root, f"step_{step:08d}")

    def extras(self, step: int | None = None) -> dict:
        """The JSON extras of a checkpoint (the latest by default), without
        loading its tensors: what a caller needs to build its template."""
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f).get("extras", {})

    def restore_reference(self, step: int | None = None) -> tuple[Any, dict]:
        """A checkpoint the reference's ``CheckpointManager`` wrote under
        this root (the latest by default) → (tree of numpy arrays, extras);
        ``convert.model_params_from_reference`` and
        ``convert.opt_state_from_reference`` turn its parameters and
        optimizer state into the port's."""
        return _read_reference(self._step_dir(step))

    def restore(self, template: Any, step: int | None = None,
                shardings: Any | None = None) -> tuple[Any, dict]:
        """Restore into ``template``'s structure → (tree, extras).

        ``shardings``: optional tree of ``(DeviceMesh, placements)`` pairs in
        ``template``'s structure (``None`` or a missing key: unplaced).  Each
        tensor is distributed by its pair, or, without one, as its template
        leaf is when that is a DTensor — restoring onto another mesh than
        the one that saved is the same call."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = torch.load(os.path.join(d, "tensors.pt"), map_location="cpu",
                          weights_only=True)
        tree = _placed(unflatten(template, flat), template, shardings)
        return tree, manifest.get("extras", {})
