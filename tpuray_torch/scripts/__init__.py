"""The port's profiling and validation entry points, counterparts of the
JAX package's ``scripts/profile_tri.py``, ``scripts/profile_replay.py`` and
``scripts/validate.py``.  The rest of that directory (the gather and
resolve studies, the overflow forensics) served the TPU kernel alone and
has no counterpart."""
