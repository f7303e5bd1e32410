"""The benchmark's own machinery: discovery by name, the program adapter,
the timed window, the traced window, the check against ``reference/``."""
