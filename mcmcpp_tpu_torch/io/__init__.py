"""IO subsystem: pluggable data writers + checkpoint/resume.

The reference PLANNED exactly this engine × output-shape matrix but never
implemented it — ``MCMCpp/IO/DataWriter.h``, ``IO/Engines/{Binary,Csv,Hdf,
Root}Engine.h`` and ``IO/OutputBases/{Scalar,Matrix,Hist1d,Hist2d,
HistMulti}.h`` are all 0-byte placeholder files (SURVEY.md §2 #31). This is
the realized design: engines own the file format, outputs adapt framework
objects (chains, histograms, matrices, scalars) into named arrays, and
:class:`DataWriter` routes outputs to an engine. CERN-ROOT output is out of
scope; HDF5 takes its slot (gated on h5py).

Checkpoint/resume (absent from the reference, SURVEY.md §5) lives in
``mcmcpp_tpu_torch.io.checkpoint``.
"""

from mcmcpp_tpu_torch.io.engines import BinaryEngine, CsvEngine, Hdf5Engine, NpzEngine
from mcmcpp_tpu_torch.io.outputs import (
    ScalarOutput,
    MatrixOutput,
    Hist1dOutput,
    Hist2dOutput,
    HistMultiOutput,
    ChainOutput,
)
from mcmcpp_tpu_torch.io.writer import DataWriter
from mcmcpp_tpu_torch.io.checkpoint import save_checkpoint, load_checkpoint

__all__ = [
    "DataWriter",
    "BinaryEngine",
    "CsvEngine",
    "Hdf5Engine",
    "NpzEngine",
    "ScalarOutput",
    "MatrixOutput",
    "Hist1dOutput",
    "Hist2dOutput",
    "HistMultiOutput",
    "ChainOutput",
    "save_checkpoint",
    "load_checkpoint",
]
