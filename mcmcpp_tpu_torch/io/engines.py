"""Storage engines: one file format each.

Realizes the reference's empty ``IO/Engines/*.h`` placeholders (SURVEY.md §2
#31). Engine contract: ``open(path)``, ``write(name, array, meta)``,
``close()``; usable as context managers. All engines accept NumPy arrays of
any rank (outputs in outputs.py reduce framework objects to named arrays).
"""

import csv
import json
import os
from pathlib import Path

import numpy as np


class _EngineBase:
    def __init__(self, path):
        self.path = Path(path)
        self._open = False

    def open(self):
        self._open = True
        return self

    def close(self):
        self._open = False

    def abort(self):
        """Close WITHOUT finalizing (no archive/manifest written); used by
        DataWriter when the managed body raised."""
        self._open = False

    def __enter__(self):
        return self.open()

    def __exit__(self, *exc):
        self.close()
        return False

    def write(self, name, array, meta=None):
        raise NotImplementedError


class CsvEngine(_EngineBase):
    """Directory of one CSV per output. 1-D → one row per element with
    index; 2-D → rows; >2-D → flattened with a shape header comment.
    Matches the ad-hoc CSV format the reference's analysis classes wrote
    (``Analysis/CornerHistograms.h:231-294``) while unifying it per-engine."""

    def open(self):
        self.path.mkdir(parents=True, exist_ok=True)
        return super().open()

    def write(self, name, array, meta=None):
        array = np.asarray(array)
        fp = self.path / f"{name}.csv"
        with open(fp, "w", newline="") as f:
            w = csv.writer(f)
            if meta:
                f.write(f"# {json.dumps(meta)}\n")
            f.write(f"# shape={list(array.shape)} dtype={array.dtype.name}\n")
            a2 = np.atleast_2d(array.reshape(array.shape[0], -1) if array.ndim
                               else array.reshape(1, 1))
            for row in a2:
                w.writerow(np.ravel(row).tolist())
        return fp


class BinaryEngine(_EngineBase):
    """Directory of raw ``.npy`` files + a JSON manifest (self-describing)."""

    def open(self):
        self.path.mkdir(parents=True, exist_ok=True)
        self._manifest = {}
        return super().open()

    def write(self, name, array, meta=None):
        array = np.asarray(array)
        fp = self.path / f"{name}.npy"
        np.save(fp, array)
        self._manifest[name] = {
            "file": fp.name,
            "shape": list(array.shape),
            "dtype": array.dtype.name,
            "meta": meta or {},
        }
        return fp

    def close(self):
        if self._open:
            with open(self.path / "manifest.json", "w") as f:
                json.dump(self._manifest, f, indent=1)
        super().close()


class NpzEngine(_EngineBase):
    """Single compressed ``.npz`` archive holding every output."""

    def open(self):
        if self.path.suffix != ".npz":
            # np.savez appends .npz itself; keep self.path == the real file
            self.path = self.path.with_name(self.path.name + ".npz")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._arrays = {}
        self._meta = {}
        return super().open()

    def write(self, name, array, meta=None):
        self._arrays[name] = np.asarray(array)
        if meta:
            self._meta[name] = meta
        return self.path

    def close(self):
        if self._open:
            payload = dict(self._arrays)
            payload["__meta__"] = np.frombuffer(
                json.dumps(self._meta).encode(), dtype=np.uint8
            )
            np.savez_compressed(self.path, **payload)
        super().close()


class Hdf5Engine(_EngineBase):
    """One HDF5 file; outputs are datasets, meta goes to attrs. Gated on
    h5py (raises ImportError with guidance if unavailable)."""

    def open(self):
        try:
            import h5py
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "Hdf5Engine requires h5py; use NpzEngine or BinaryEngine"
            ) from e
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._h5 = h5py.File(self.path, "w")
        return super().open()

    def abort(self):
        if self._open:
            self._h5.close()
            self.path.unlink(missing_ok=True)  # file was created at open()
        super().abort()

    def write(self, name, array, meta=None):
        ds = self._h5.create_dataset(name, data=np.asarray(array))
        for k, v in (meta or {}).items():
            # h5py attrs accept scalars/strings only; JSON-encode the rest
            # so every engine tolerates the same meta values
            if v is None or isinstance(v, (dict, list, tuple)):
                v = json.dumps(v)
            ds.attrs[k] = v
        return self.path

    def close(self):
        if self._open:
            self._h5.close()
        super().close()


def read_npz(path):
    """Load an NpzEngine archive back into ({name: array}, {name: meta})."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
        meta = {}
        if "__meta__" in z.files:
            meta = json.loads(bytes(z["__meta__"]).decode())
    return arrays, meta
