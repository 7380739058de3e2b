"""Import-path shim for ``minimagen.diffusion_model`` (the reference's
diffusion_model.py exports GaussianDiffusion)."""
from .ops.diffusion import GaussianDiffusion, create_gaussian_diffusion  # noqa: F401
