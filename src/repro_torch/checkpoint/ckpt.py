"""Checkpointing (port of ``repro/checkpoint/ckpt.py``), in the
reference's on-disk format, so either package restores what the other
wrote:

    <dir>/step_%08d/arrays.npz      every leaf by its "/"-joined path
    <dir>/step_%08d/manifest.json   {"step", "extra", "leaves", "bit_dtypes"}

bf16 (which npz cannot hold) is stored as its raw uint16 bits and named
in ``bit_dtypes``. The arrays go to the host synchronously; the file
write runs on a background thread with ``blocking=False``, and ``wait()``
fences it before the next save or exit. ``arrays.npz`` is written to a
temporary file and renamed, and the manifest is written last, so a step
without a manifest is not a checkpoint (``latest_step`` skips it).

``restore(..., shardings=)`` (the reference's elastic re-mesh) waits for
the port's mesh and refuses with a message.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Optional

import numpy as np

from repro_torch.convert import tensor_from_numpy, tensor_to_numpy
from repro_torch.utils import flatten_with_paths, map_with_paths

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


class Checkpointer:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[dict] = None,
             blocking: bool = True) -> str:
        self.wait()
        host, dtypes = {}, {}
        for k, v in flatten_with_paths(state).items():
            if v is None:
                continue
            # a copy, never a view: training goes on updating the state in
            # place while the background thread writes these arrays
            host[k], bit_dtype = tensor_to_numpy(v.detach().to("cpu", copy=True))
            if bit_dtype is not None:
                dtypes[k] = bit_dtype
        path = os.path.join(self.directory, f"step_{step:08d}")
        manifest = {"step": step, "extra": extra or {},
                    "leaves": sorted(host.keys()), "bit_dtypes": dtypes}

        def write():
            os.makedirs(path, exist_ok=True)
            with tempfile.NamedTemporaryFile(dir=path, delete=False, suffix=".tmp") as f:
                np.savez(f, **host)
                tmp = f.name
            os.replace(tmp, os.path.join(path, _ARRAYS))
            with open(os.path.join(path, _MANIFEST), "w") as f:
                json.dump(manifest, f)

        if blocking:
            write()
        else:
            def run():
                try:
                    write()
                except BaseException as e:   # re-raised by wait()
                    self._error = e
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        return path

    def wait(self):
        """Fence the background write; re-raises its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = [int(d.split("_")[1]) for d in os.listdir(self.directory)
                 if d.startswith("step_") and
                 os.path.exists(os.path.join(self.directory, d, _MANIFEST))]
        return max(steps) if steps else None

    def _step_dir(self, step: Optional[int]) -> str:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return os.path.join(self.directory, f"step_{step:08d}")

    def restore(self, template: Any, step: Optional[int] = None, device=None,
                shardings: Any = None) -> tuple[Any, dict]:
        """Restore into the structure of ``template`` (a dict tree of tensors):
        each leaf in its template's dtype, on ``device`` (default: the
        template leaf's device). -> (state, manifest)."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=): elastic re-meshing comes with the training "
                "mesh (ROADMAP item 8); restore onto one device")
        path = self._step_dir(step)
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        bit_dtypes = manifest.get("bit_dtypes", {})
        with np.load(os.path.join(path, _ARRAYS)) as data:
            def leaf(k, tmpl):
                if tmpl is None:
                    return None
                t = tensor_from_numpy(data[k], bit_dtypes.get(k),
                                      device=tmpl.device if device is None else device)
                return t.to(tmpl.dtype)
            restored = map_with_paths(leaf, template)
        return restored, manifest

    def restore_manifest(self, step: Optional[int] = None) -> dict:
        with open(os.path.join(self._step_dir(step), _MANIFEST)) as f:
            return json.load(f)

