"""Launch layer: the production meshes (``mesh``), the serving entry point
(``python -m repro_torch.launch.serve``) and the trainer (``python -m
repro_torch.launch.train``)."""

from . import mesh

__all__ = ["mesh"]
