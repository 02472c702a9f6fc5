"""The device mesh (``--num-devices``, ``--tp``): ``mesh.py`` (ranks,
groups, launcher), ``collectives.py`` (the collectives as autograd
Functions, the global-batch reductions) and ``tp.py`` (tensor
parallelism, imported where it is used)."""
from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    current,
    is_writer,
    launch,
    make_mesh,
    replicated,
)
