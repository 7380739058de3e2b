"""Import-path shim for ``minimagen.Unet`` (the reference's Unet.py exports
Unet, Base, Super, BaseTest and SuperTest)."""
from .models.unet import (  # noqa: F401
    Base,
    BaseTest,
    Super,
    SuperTest,
    Unet,
    UnetConfig,
    UnetModel,
)
