"""Checkpointing: atomic, optionally asynchronous, keep-N.

Port of ``repro.checkpoint.manager.CheckpointManager`` in the port's own
format (the reference's ``.npy`` directories are not read)::

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
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import torch

__all__ = ["CheckpointManager", "flatten", "unflatten"]


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
        """Snapshot ``tree`` + JSON-able ``extras`` as step ``step``."""
        host = {
            k: (v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor)
                else torch.tensor(v))
            for k, v in flatten(tree).items()
        }

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

    def restore(self, template: Any, step: int | None = None) -> tuple[Any, dict]:
        """Restore into ``template``'s structure → (tree, extras)."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = torch.load(os.path.join(d, "tensors.pt"), map_location="cpu",
                          weights_only=True)
        return unflatten(template, flat), manifest.get("extras", {})
