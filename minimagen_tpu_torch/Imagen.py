"""Import-path shim: the reference exposes ``minimagen.Imagen.Imagen``; this
module mirrors that path (as ``minimagen_tpu/Imagen.py`` does), so
reference user code ports by renaming the package."""
from .models.imagen import Imagen  # noqa: F401
