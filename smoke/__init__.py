"""The phases of ``chip_smoke.py``, the port's check on one H100, one
module a group of phases; ``smoke.timing`` is also the library of
``tools/*_times.py``."""
