"""Disk-backed chain store: sample histories larger than host RAM.

The reference's chain is strictly in-memory and byte-capped — overflow
ends the run (``MCMCpp/Chain/Chain.h:230-234``). The in-RAM :class:`Chain`
here keeps those semantics; :class:`DiskChain` is the production
alternative: every appended chunk is spooled to an ``.npy`` block file
under a directory (atomic manifest), reads memory-map blocks and
materialize only the selected rows, and ``iter_blocks`` streams for
O(block) analyses (pairs with ``analysis.StreamingACT``). Same surface as
:class:`Chain` (append/get/get_logp/n_steps/clear/compact), so it drops
into the sampler via the ``chain=`` constructor argument. Counterpart of
``mcmcpp_tpu/chain_disk.py``. Rows of a dtype numpy lacks (bfloat16, the
8-bit floats) are spooled as their raw bits, with the dtype's name in the
manifest, and read back as float32 (see :mod:`mcmcpp_tpu_torch.chain`).
"""

import json
import os
import shutil
from pathlib import Path

import numpy as np

from mcmcpp_tpu_torch.chain import cast_up, from_held, row_dtype, to_held


class DiskChain:
    """Append-only (step, walker, param) store spooled to a directory."""

    _MANIFEST = "manifest.json"

    def __init__(self, directory, n_walkers, n_params, dtype=np.float32,
                 max_bytes=None):
        self.dir = Path(directory)
        self.n_walkers = int(n_walkers)
        self.n_params = int(n_params)
        self.dtype = row_dtype(dtype)
        # None = default 1 TiB for new spools, manifest value on reopen;
        # an explicit cap always wins
        self._explicit_max = max_bytes is not None
        self.max_bytes = int(max_bytes) if self._explicit_max else (1 << 40)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._blocks = []  # list of (filename, steps)
        self._bytes = 0
        self._next_id = 0
        existing = self.dir / self._MANIFEST
        if existing.exists():
            self._load_manifest()
        else:
            self._write_manifest()

    # -- manifest ----------------------------------------------------------

    def _write_manifest(self):
        meta = {
            "n_walkers": self.n_walkers,
            "n_params": self.n_params,
            "dtype": self.dtype.name,
            "max_bytes": self.max_bytes,
            "blocks": self._blocks,
            "next_id": self._next_id,
        }
        tmp = self.dir / (self._MANIFEST + ".tmp")
        tmp.write_text(json.dumps(meta))
        os.replace(tmp, self.dir / self._MANIFEST)

    def _load_manifest(self):
        meta = json.loads((self.dir / self._MANIFEST).read_text())
        if (meta["n_walkers"], meta["n_params"]) != (
            self.n_walkers, self.n_params
        ):
            raise ValueError(
                f"directory holds a ({meta['n_walkers']}, "
                f"{meta['n_params']}) chain, asked for "
                f"({self.n_walkers}, {self.n_params})"
            )
        self.dtype = row_dtype(meta["dtype"])
        # resume with the cap the spool was created with (EndOfChain
        # semantics must survive reopen) unless the caller overrode it
        if not self._explicit_max and "max_bytes" in meta:
            self.max_bytes = int(meta["max_bytes"])
        self._blocks = [tuple(b) for b in meta["blocks"]]
        self._next_id = int(meta["next_id"])
        self._bytes = sum(s * self._row_bytes() for _, s in self._blocks)

    @classmethod
    def open(cls, directory):
        """Reopen an existing spool directory (resume/analysis); the byte
        cap is restored from the manifest."""
        meta = json.loads((Path(directory) / cls._MANIFEST).read_text())
        return cls(directory, meta["n_walkers"], meta["n_params"],
                   dtype=meta["dtype"])

    @property
    def backend(self):
        return "disk"

    # -- writing -----------------------------------------------------------

    def _row_bytes(self):
        return self.n_walkers * (self.n_params + 1) * self.dtype.itemsize

    def append(self, positions, logps=None):
        """Append (S, W, P) (+ optional (S, W) logp); False once the disk
        byte budget is exhausted (EndOfChain semantics, partial append)."""
        if positions.ndim != 3 or tuple(positions.shape[1:]) != (
            self.n_walkers, self.n_params,
        ):
            raise ValueError(
                f"expected (S, {self.n_walkers}, {self.n_params}), "
                f"got {tuple(positions.shape)}"
            )
        if logps is not None and (
                tuple(logps.shape) != tuple(positions.shape[:2])):
            raise ValueError("logps shape must be (S, W)")
        positions = to_held(positions, self.dtype)
        if logps is None:
            logps = np.zeros(positions.shape[:2], positions.dtype)
        else:
            logps = to_held(logps, self.dtype)
        room = (self.max_bytes - self._bytes) // self._row_bytes()
        take = min(positions.shape[0], max(room, 0))
        if take > 0:
            name = f"block_{self._next_id:06d}"
            np.save(self.dir / f"{name}.npy", positions[:take])
            np.save(self.dir / f"{name}_logp.npy", logps[:take])
            self._blocks.append((name, int(take)))
            self._next_id += 1
            self._bytes += take * self._row_bytes()
            self._write_manifest()
        return take == positions.shape[0]

    def clear(self):
        for name, _ in self._blocks:
            (self.dir / f"{name}.npy").unlink(missing_ok=True)
            (self.dir / f"{name}_logp.npy").unlink(missing_ok=True)
        self._blocks = []
        self._bytes = 0
        self._write_manifest()

    # -- reading -----------------------------------------------------------

    @property
    def n_steps(self):
        return sum(s for _, s in self._blocks)

    @property
    def nbytes(self):
        return self._bytes

    def iter_blocks(self, logp=False):
        """Yield each block as a read-only memmap (O(block) memory)."""
        for name, _ in self._blocks:
            suffix = "_logp" if logp else ""
            yield np.load(self.dir / f"{name}{suffix}.npy", mmap_mode="r")

    @staticmethod
    def _block_slice(seen, s, burn_in, thin):
        """Slice selecting global rows >= burn_in with
        (idx - burn_in) % thin == 0 inside a block spanning
        [seen, seen + s); None if nothing selected."""
        start = max(burn_in - seen, 0)
        if start >= s:
            return None
        off = (-(seen + start - burn_in)) % thin
        if start + off >= s:
            return None
        return slice(start + off, s, thin)

    def _gather(self, burn_in, thin, logp, held=False):
        burn_in, thin = int(burn_in), int(thin)
        out, seen = [], 0
        for block in self.iter_blocks(logp=logp):
            s = block.shape[0]
            sl = self._block_slice(seen, s, burn_in, thin)
            if sl is not None:  # only selected rows materialize
                out.append(np.asarray(block[sl]))
            seen += s
        if not out:
            shape = (0, self.n_walkers) + (() if logp else (self.n_params,))
            arr = np.empty(shape, getattr(self.dtype, "bits", self.dtype))
        else:
            arr = np.concatenate(out, axis=0)
        return arr if held else cast_up(arr, self.dtype, None)

    def get(self, burn_in=0, thin=1, flat=False, held=False):
        arr = self._gather(burn_in, thin, logp=False, held=held)
        return arr.reshape(-1, self.n_params) if flat else arr

    def get_logp(self, burn_in=0, thin=1, flat=False, held=False):
        arr = self._gather(burn_in, thin, logp=True, held=held)
        return arr.reshape(-1) if flat else arr

    def iter_steps(self, burn_in=0, thin=1):
        for row in self.get(burn_in=burn_in, thin=thin):
            yield row

    def compact(self, burn_in=0, thin=1):
        """In-place burn+thin (≙ ``resetChainForSubSampling``): rewrite the
        spool block-by-block (never materializing the whole chain). The
        manifest replacement is the atomic commit point — a crash at any
        moment leaves a manifest whose listed blocks all exist (old set
        before the commit, new set after; stray files are garbage, not
        data loss)."""
        burn_in, thin = int(burn_in), int(thin)
        tmp = self.dir.with_name(self.dir.name + ".compact-tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        fresh = DiskChain(tmp, self.n_walkers, self.n_params,
                          dtype=self.dtype, max_bytes=self.max_bytes)
        fresh._next_id = self._next_id  # new names never collide with live
        seen = 0
        for pos, lp in zip(self.iter_blocks(), self.iter_blocks(logp=True)):
            sl = self._block_slice(seen, pos.shape[0], burn_in, thin)
            if sl is not None:
                fresh.append(from_held(pos[sl], self.dtype),
                             from_held(lp[sl], self.dtype))
            seen += pos.shape[0]
        old_blocks = list(self._blocks)
        # stage the new blocks alongside the old, then COMMIT via the
        # manifest, then garbage-collect the old files
        for name, _ in fresh._blocks:
            os.replace(tmp / f"{name}.npy", self.dir / f"{name}.npy")
            os.replace(tmp / f"{name}_logp.npy",
                       self.dir / f"{name}_logp.npy")
        self._blocks = fresh._blocks
        self._bytes = fresh._bytes
        self._next_id = fresh._next_id
        self._write_manifest()  # <- commit point (atomic os.replace inside)
        for name, _ in old_blocks:
            (self.dir / f"{name}.npy").unlink(missing_ok=True)
            (self.dir / f"{name}_logp.npy").unlink(missing_ok=True)
        shutil.rmtree(tmp)
        return self
