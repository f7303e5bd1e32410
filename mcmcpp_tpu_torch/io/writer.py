"""DataWriter: routes outputs into an engine.

Realizes the reference's 0-byte ``MCMCpp/IO/DataWriter.h`` (SURVEY.md §2
#31): the writer owns an engine, accepts any mix of Output adapters (or raw
named arrays), and writes them all on ``flush``/context exit.
"""

from mcmcpp_tpu_torch.io.outputs import Output


class DataWriter:
    """Collects outputs and streams them to ``engine`` (open on entry)."""

    def __init__(self, engine):
        self.engine = engine
        self._pending = []

    def add(self, output_or_name, array=None, meta=None):
        """Queue an Output, or a raw (name, array[, meta]) triple."""
        if isinstance(output_or_name, Output):
            self._pending.append(output_or_name)
        else:
            from mcmcpp_tpu_torch.io.outputs import MatrixOutput

            self._pending.append(MatrixOutput(output_or_name, array, meta))
        return self

    def flush(self):
        for out in self._pending:
            for name, array, meta in out.emit():
                self.engine.write(name, array, meta)
        self._pending.clear()
        return self

    def __enter__(self):
        self.engine.open()
        return self

    def __exit__(self, exc_type, exc, tb):
        # transactional: when the body raised, discard pending outputs and
        # abort the engine so no partial/empty artifact is finalized
        if exc_type is None:
            self.flush()
            self.engine.close()
        else:
            self._pending.clear()
            self.engine.abort()
        return False
