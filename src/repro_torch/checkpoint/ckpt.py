"""Checkpoint/restart of the training state (the port of the JAX
package's ``checkpoint/ckpt.py``, on torch tensors).

Layout per step:  <dir>/step_<n>/
    manifest.json   — leaf paths, shapes, dtypes, sha256 per file,
                      data-pipeline state, user metadata
    <leaf>.npy      — one file per leaf of the state tree

  * **async** — ``save()`` copies every tensor to the host synchronously
    (a consistent view) and writes the files on a background thread;
    ``wait()`` joins before the next save or exit.
  * **atomic** — written under ``.tmp_step_<n>``, fsync'd, then renamed;
    a crashed save never corrupts the latest complete step.
  * **integrity** — every file carries its sha256 in the manifest, checked
    on restore.
  * A state tree is nested dicts of tensors.  bf16 (which numpy lacks) is
    stored as its uint16 bits, with "bfloat16" as the dtype in the
    manifest, so a restore gives back the same bits.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_BF16 = "bfloat16"


def _leaf_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/c": leaf} over nested mappings, in insertion order."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_leaf_paths(val, path + "/"))
        else:
            out[path] = val
    return out


def _unflatten(template, leaves: Dict[str, Any], prefix: str = ""):
    return {key: (_unflatten(val, leaves, f"{prefix}{key}/")
                  if isinstance(val, Mapping) else leaves[f"{prefix}{key}"])
            for key, val in template.items()}


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    return t.numpy(), str(t.numpy().dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save -----------------------------------------------------------------

    def save(self, step: int, state_tree, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        self.wait()
        # synchronous device -> host snapshot (a consistent view)
        host = {k: _to_host(torch.as_tensor(v))
                for k, v in _leaf_paths(state_tree).items()}
        meta = {"step": int(step), "extra": extra or {}}

        def write():
            try:
                tmp = os.path.join(self.dir, f".tmp_step_{step}")
                final = os.path.join(self.dir, f"step_{step}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                manifest = {"step": meta["step"], "extra": meta["extra"],
                            "leaves": {}}
                for i, (key, (arr, dtype)) in enumerate(host.items()):
                    fn = f"{i:05d}_{_safe(key)}.npy"
                    fp = os.path.join(tmp, fn)
                    np.save(fp, arr)
                    with open(fp, "rb") as f:
                        digest = hashlib.sha256(f.read()).hexdigest()
                    manifest["leaves"][key] = {
                        "file": fn, "shape": list(arr.shape),
                        "dtype": dtype, "sha256": digest,
                    }
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if blocking:
            write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint failed: {err!r}") from err

    def _gc(self):
        steps = sorted(self.list_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def list_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template_tree, device=None,
                verify: bool = True) -> Tuple[Any, Dict]:
        """Rebuild ``template_tree``'s structure from disk: each leaf in
        the template leaf's dtype, on ``device`` (default: the template
        leaf's device, the CPU for a ``meta`` leaf).  Returns (tree,
        extra with "step")."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        for key, leaf in _leaf_paths(template_tree).items():
            entry = manifest["leaves"][key]
            fp = os.path.join(d, entry["file"])
            if verify:
                with open(fp, "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
                if digest != entry["sha256"]:
                    raise IOError(f"checkpoint corruption in {key}")
            t = _from_host(np.load(fp), entry["dtype"])
            dev = device if device is not None else (
                "cpu" if leaf.device.type == "meta" else leaf.device)
            out[key] = t.to(device=dev, dtype=leaf.dtype)
        return (_unflatten(template_tree, out),
                manifest["extra"] | {"step": manifest["step"]})


def _safe(key: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in key)
