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

On a training mesh (``launch.mesh.ServingMesh``) ``save(shardings=,
mesh=)`` gathers each leaf whole from every rank's slice and the mesh's
first rank writes (on its background thread with ``blocking=False``);
every rank fences at ``wait()``, which also waits for the whole mesh, so
no rank reads a checkpoint before it is written. ``restore(shardings=,
mesh=)`` reads whole arrays and returns this rank's ``local_slice`` under
each placement, the reference's ``device_put(arr, sh)``: a checkpoint
written on one mesh restores on any other, or on one device, unchanged
(the elastic re-mesh).
"""
from __future__ import annotations

import io
import json
import os
import tempfile
import threading
import zipfile
import zlib
from typing import Any, Optional

import numpy as np

from repro_torch.convert import tensor_from_numpy, tensor_to_numpy
from repro_torch.utils import flatten_with_paths, map_with_paths

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


class _Npz:
    """An ``np.savez`` file's arrays by name, each read from one memory map
    of the file after its member's CRC-32 is checked, as ``np.load``
    checks it (which copies every member through 16 MB chunks). Both
    packages write with ``np.savez``, whose members are stored, not
    compressed; any other member is refused."""

    def __init__(self, path: str):
        self._path = path
        self._zf = zipfile.ZipFile(path)
        self._mm = np.memmap(path, mode="r")

    def __enter__(self) -> "_Npz":
        return self

    def __exit__(self, *exc) -> None:
        self._zf.close()
        self._mm = None

    def __getitem__(self, key: str) -> np.ndarray:
        fmt = np.lib.format
        info = self._zf.getinfo(key + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"{self._path}: member {key!r} is compressed; checkpoints "
                             f"are written by np.savez, which stores members")
        h = info.header_offset
        local = bytes(self._mm[h:h + 30])       # the member's local file header
        start = h + 30 + int.from_bytes(local[26:28], "little") + \
            int.from_bytes(local[28:30], "little")
        data = self._mm[start:start + info.file_size]
        if zlib.crc32(data) != info.CRC:
            raise ValueError(f"{self._path}: member {key!r} fails its CRC-32")
        fp = io.BytesIO(bytes(data[:65536 + 16]))
        version = fmt.read_magic(fp)
        read = fmt.read_array_header_1_0 if version == (1, 0) else fmt.read_array_header_2_0
        shape, fortran, dtype = read(fp)
        return np.ndarray(shape, dtype, buffer=data, offset=fp.tell(),
                          order="F" if fortran else "C")


class Checkpointer:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[dict] = None,
             blocking: bool = True, shardings: Any = None, mesh=None) -> str:
        """Write ``state`` as step ``step``. With ``shardings`` (a placement
        tree mirroring ``state``) and ``mesh``, ``state`` holds this rank's
        slices: every rank of the mesh must call this; the mesh's first
        rank writes."""
        from repro_torch.launch.mesh import gather_whole
        self.wait()
        if (shardings is None) != (mesh is None):
            raise ValueError("save on a mesh takes both shardings= and mesh=")
        flat_s = flatten_with_paths(shardings) if shardings is not None else {}
        writer = mesh is None or not any(mesh.coords.values())
        host, dtypes = {}, {}
        for k, v in flatten_with_paths(state).items():
            if v is None:
                continue
            if mesh is not None:
                v = gather_whole(v.detach(), tuple(flat_s[k]), mesh)
            if not writer:
                continue
            # a copy, never a view: training goes on updating the state in
            # place while the background thread writes these arrays
            host[k], bit_dtype = tensor_to_numpy(v.detach().to("cpu", copy=True))
            if bit_dtype is not None:
                dtypes[k] = bit_dtype
        path = os.path.join(self.directory, f"step_{step:08d}")
        self._mesh = mesh
        if not writer:
            return path
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
        """Fence the background write; re-raises its error, if any. After a
        save on a mesh every rank calls it, and it returns on each once
        the write is done."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            mesh.barrier()

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
                shardings: Any = None, mesh=None) -> tuple[Any, dict]:
        """Restore into the structure of ``template`` (a dict tree of tensors):
        each leaf in its template's dtype, on ``device`` (default: the
        template leaf's device). With ``shardings`` (a placement tree
        mirroring ``template``) and ``mesh``, each leaf is this rank's
        ``launch.mesh.local_slice`` of the whole array, whatever mesh wrote
        it. -> (state, manifest)."""
        from repro_torch.launch.mesh import local_slice
        if (shardings is None) != (mesh is None):
            raise ValueError("restore on a mesh takes both shardings= and mesh=")
        flat_s = flatten_with_paths(shardings) if shardings is not None else {}
        path = self._step_dir(step)
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        bit_dtypes = manifest.get("bit_dtypes", {})
        with _Npz(os.path.join(path, _ARRAYS)) as data:
            def leaf(k, tmpl):
                if tmpl is None:
                    return None
                t = tensor_from_numpy(data[k], bit_dtypes.get(k),
                                      device=tmpl.device if device is None else device)
                if mesh is not None:
                    t = local_slice(t, tuple(flat_s[k]), mesh)
                return t.to(tmpl.dtype)
            restored = map_with_paths(leaf, template)
        return restored, manifest

    def restore_manifest(self, step: Optional[int] = None) -> dict:
        with open(os.path.join(self._step_dir(step), _MANIFEST)) as f:
            return json.load(f)

