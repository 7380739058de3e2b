"""Import-path shim for ``minimagen.layers`` (the reference's layers.py)."""
from .models.layers import (  # noqa: F401
    Attention,
    Block,
    ChanFeedForward,
    ChanLayerNorm,
    CrossAttention,
    CrossEmbedLayer,
    Downsample,
    GroupNorm,
    LayerNorm,
    ParallelSum,
    ResnetBlock,
    TransformerBlock,
    Upsample,
    sinusoidal_pos_emb,
)
