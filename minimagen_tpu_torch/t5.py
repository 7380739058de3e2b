"""Import-path shim for ``minimagen.t5`` (the reference's t5.py)."""
from .models.t5 import (  # noqa: F401
    DEFAULT_T5_NAME,
    MAX_LENGTH,
    T5_VERSIONS,
    get_encoded_dim,
    t5_encode_text,
)
