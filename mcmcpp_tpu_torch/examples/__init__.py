"""The reference's three test programs on the port (counterparts of the
repo's ``examples/skewed_gaussian.py``, ``actime.py`` and
``inner_benchmark.py``): ``python -m mcmcpp_tpu_torch.examples.<name>``."""
