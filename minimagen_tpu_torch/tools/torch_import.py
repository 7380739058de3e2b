"""Reference MinImagen ``.pth`` checkpoints in and out of the port
(counterpart of ``minimagen_tpu/tools/torch_import.py``).

The reference trains each U-Net with its own module tree and saves its
``state_dict`` as a ``.pth`` file. :func:`convert_unet_state_dict` maps one
onto the port's ``UnetModel`` state_dict and :func:`export_unet_state_dict`
maps back; ``python -m minimagen_tpu_torch.tools.torch_import
import|export SRC DST`` converts whole training directories.

The name table (:func:`_mapping`) is the JAX module's
``convert_unet_state_dict`` and ``_reference_key_list`` copied: one entry
per port parameter, the reference key it comes from and the layout
transform. The port's layout is already PyTorch's (OIHW convolutions,
(out, in) linears), so most entries are renames; the others are
- ``conv1x1``: a reference 1x1 convolution (out, in, 1, 1) that the port
  computes as a ``Dense`` (out, in) (the feed-forwards of the
  TransformerBlocks);
- ``chan``: a ChanLayerNorm's (1, c, 1, 1) gain, the port's (c,).
Every other entry is the identity: linears and convolutions, the
GroupNorms' ``weight``/``bias`` (the port's ``scale``/``bias``), the
scale-only LayerNorms' ``gamma`` (the reference also keeps a frozen-zero
``beta`` buffer, which the export writes as zeros), the affine LayerNorms'
``weight``/``bias`` (``gamma``/``beta``) and the learned null embeddings.
"""
from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.unet import UnetConfig

Entry = Tuple[str, str, str]  # (port parameter, reference key, transform)

_FORWARD = {"id": lambda t: t, "conv1x1": lambda t: t[:, :, 0, 0],
            "chan": lambda t: t.reshape(-1)}
_BACKWARD = {"id": lambda t: t, "conv1x1": lambda t: t[:, :, None, None],
             "chan": lambda t: t.reshape(1, -1, 1, 1)}
STEM_CONVS = 3  # the reference CrossEmbedLayer's kernels (3, 7, 15)


def _mapping(config: UnetConfig, n_stem: int = STEM_CONVS) -> List[Entry]:
    """Every port parameter of a U-Net of `config`, with its reference key
    and transform (reference ``Unet.py:25-328``, as the JAX converter reads
    it)."""
    out: List[Entry] = []

    def add(port, ref, kind="id"):
        out.append((port, ref, kind))

    def linear(port, ref, bias=True):
        add(f"{port}.weight", f"{ref}.weight")
        if bias:
            add(f"{port}.bias", f"{ref}.bias")

    conv = linear

    def scale_ln(port, ref):
        add(f"{port}.gamma", f"{ref}.gamma")

    def affine_ln(port, ref):
        add(f"{port}.gamma", f"{ref}.weight")
        add(f"{port}.beta", f"{ref}.bias")

    def attention(port, ref):
        """Reference Attention (layers.py:14-104) / CrossAttention
        (layers.py:180-251)."""
        scale_ln(f"{port}.norm", f"{ref}.norm")
        add(f"{port}.null_kv", f"{ref}.null_kv")
        linear(f"{port}.to_q", f"{ref}.to_q", bias=False)
        linear(f"{port}.to_kv", f"{ref}.to_kv", bias=False)
        linear(f"{port}.to_out", f"{ref}.to_out.0", bias=False)
        scale_ln(f"{port}.out_norm", f"{ref}.to_out.1")

    def block(port, ref):
        add(f"{port}.groupnorm.scale", f"{ref}.groupnorm.weight")
        add(f"{port}.groupnorm.bias", f"{ref}.groupnorm.bias")
        conv(f"{port}.project", f"{ref}.project")

    def resnet(port, ref, has_cross=False, has_res=False):
        linear(f"{port}.time_mlp", f"{ref}.time_mlp.1")
        block(f"{port}.block1", f"{ref}.block1")
        if has_cross:  # EinopsToAndFrom wraps the CrossAttention as .fn (layers.py:403-410)
            attention(f"{port}.cross_attn", f"{ref}.cross_attn.fn")
        block(f"{port}.block2", f"{ref}.block2")
        if has_res:
            conv(f"{port}.res_conv", f"{ref}.res_conv")

    def transformer(port, ref):
        """Reference TransformerBlock (layers.py:468-499): the attention
        wrapped as .fn; ff = Sequential(ChanLN, 1x1, GELU, ChanLN, 1x1)."""
        attention(f"{port}.attn", f"{ref}.attn.fn")
        add(f"{port}.ff.norm_in.g", f"{ref}.ff.0.g", "chan")
        add(f"{port}.ff.expand.weight", f"{ref}.ff.1.weight", "conv1x1")
        add(f"{port}.ff.norm_mid.g", f"{ref}.ff.3.g", "chan")
        add(f"{port}.ff.project.weight", f"{ref}.ff.4.weight", "conv1x1")

    # time conditioning (reference Unet.py:101-138)
    for prefix in ("to_", "to_lowres_") if config.lowres_cond else ("to_",):
        linear(f"{prefix}time_hiddens", f"{prefix}time_hiddens.1")
        linear(f"{prefix}time_cond", f"{prefix}time_cond.0")
        linear(f"{prefix}time_tokens", f"{prefix}time_tokens.0")
    # text conditioning (reference Unet.py:142-161)
    linear("text_to_cond", "text_to_cond")
    add("null_text_embed", "null_text_embed")
    affine_ln("text_nonattn_norm", "to_text_non_attn_cond.0")
    linear("text_nonattn_dense1", "to_text_non_attn_cond.1")
    linear("text_nonattn_dense2", "to_text_non_attn_cond.3")
    add("null_text_hidden", "null_text_hidden")
    affine_ln("norm_cond", "norm_cond")
    # the stem (reference Unet.py:169-172)
    for i in range(n_stem):
        conv(f"init_conv.conv_{i}", f"init_conv.convs.{i}")

    layer_params = config.layer_params()
    last = len(layer_params) - 1
    mem_eff = config.memory_efficient
    # down path (reference Unet.py:237-261: [pre, init_block, blocks, attn, post])
    for L, (_, nblocks, _, layer_attn, layer_cross) in enumerate(layer_params):
        if mem_eff:
            conv(f"down{L}_pre.conv", f"downs.{L}.0")
        resnet(f"down{L}_init_block", f"downs.{L}.1", has_cross=layer_cross)
        for j in range(nblocks):
            resnet(f"down{L}_block{j}", f"downs.{L}.2.{j}")
        if layer_attn:
            transformer(f"down{L}_attn", f"downs.{L}.3")
        if not mem_eff:
            if L != last:
                conv(f"down{L}_post.conv", f"downs.{L}.4")
            else:
                conv(f"down{L}_post.conv3", f"downs.{L}.4.fns.0")
                conv(f"down{L}_post.conv1", f"downs.{L}.4.fns.1")
    # middle (reference Unet.py:263-278)
    resnet("mid_block1", "mid_block1", has_cross=True)
    if config.attend_at_middle:  # EinopsToAndFrom(Residual(Attention)): .fn.fn
        attention("mid_attn", "mid_attn.fn.fn")
    resnet("mid_block2", "mid_block2", has_cross=True)
    # up path (reference Unet.py:294-315: [init_block, blocks, attn, upsample])
    for R, (_, nblocks, _, layer_attn, layer_cross) in enumerate(reversed(layer_params)):
        resnet(f"up{R}_init_block", f"ups.{R}.0", has_cross=layer_cross, has_res=True)
        for j in range(nblocks):
            resnet(f"up{R}_block{j}", f"ups.{R}.1.{j}", has_res=True)
        if layer_attn:
            transformer(f"up{R}_attn", f"ups.{R}.2")
        if R != last or mem_eff:  # reference Upsample = Sequential(nearest, conv)
            conv(f"up{R}_upsample.conv", f"ups.{R}.3.1")
    # final (reference Unet.py:322-328)
    resnet("final_res_block", "final_res_block")
    conv("final_conv", "final_conv")
    return out


def _stem_count(sd: Mapping[str, object]) -> int:
    return len([k for k in sd if k.startswith("init_conv.convs.") and k.endswith(".weight")])


def convert_unet_state_dict(sd: Mapping[str, object], config: UnetConfig
                            ) -> Dict[str, torch.Tensor]:
    """A reference U-Net state_dict (tensors or numpy arrays; keys as the
    reference ``Unet`` makes them) -> the port's ``UnetModel(config)``
    state_dict (CPU tensors, dtypes kept). `config` is the U-Net's config
    after the cascade's cast (``Imagen.unet_configs``)."""
    def tensor(v):
        return v.detach().cpu() if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))

    return {port: _FORWARD[kind](tensor(sd[ref])).contiguous()
            for port, ref, kind in _mapping(config, _stem_count(sd))}


def export_unet_state_dict(state: Mapping[str, torch.Tensor], config: UnetConfig
                           ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`convert_unet_state_dict`: the port's U-Net
    state_dict -> a reference-named state_dict (CPU tensors) that the
    reference ``Unet`` loads strictly, the zero ``beta`` buffers included."""
    out = {ref: _BACKWARD[kind](state[port].detach().cpu()).contiguous()
           for port, ref, kind in _mapping(config)}
    for k in [k for k in out if k.endswith(".gamma")]:
        out[k[:-len("gamma")] + "beta"] = torch.zeros_like(out[k])
    return out


def _unet_files(directory: str) -> Tuple[str, List[str]]:
    """The subdirectory (``state_dicts``, else ``tmp``) holding a training
    directory's U-Net files, and those files."""
    for sub in ("state_dicts", "tmp"):
        files = sorted(f for f in os.listdir(os.path.join(directory, sub))
                       if f.startswith("unet_"))
        if files:
            return sub, files
    raise ValueError(f'Both "/state_dicts" and "/tmp" in {directory} are empty')


def convert_reference_training_dir(directory: str, device="cuda", dtype=torch.float32,
                                   param_dtype: Optional[torch.dtype] = None):
    """An Imagen from a reference training directory: its configs from
    ``parameters/*.json``, each U-Net's weights converted from the first
    ``unet_<i>*.pth`` of ``state_dicts/`` (``tmp/`` if that holds none, as
    the reference's generate.py:91-119 falls back)."""
    from ..generate import _instantiate_minimagen  # noqa: PLC0415 (generate imports tools)

    imagen = _instantiate_minimagen(directory, device, dtype, param_dtype)
    sub, files = _unet_files(directory)
    for i in range(imagen.num_unets):
        candidates = [f for f in files if f.startswith(f"unet_{i}") and f.endswith(".pth")]
        if not candidates:
            raise ValueError(f"no .pth checkpoint of unet {i} in {directory}/{sub}")
        load_reference_unet(os.path.join(directory, sub, candidates[0]), imagen, i)
    return imagen


def load_reference_unet(path: str, imagen, i: int) -> None:
    """A reference ``.pth`` U-Net state_dict into `imagen`'s U-Net `i`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    imagen.unets[i].load_state_dict(convert_unet_state_dict(sd, imagen.unet_configs[i]),
                                    strict=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Checkpoint conversion CLI.

    import: convert a PyTorch reference training directory into a
    minimagen_tpu_torch training directory (configs copied, .pth -> .ckpt,
    the flax-msgpack files both packages read).
    export: convert a minimagen_tpu_torch training directory's weights
    (state_dicts/, else tmp/) into reference-layout .pth files.
    The conversion moves tensors between files and computes nothing: it
    runs on the host."""
    import argparse
    import shutil

    parser = argparse.ArgumentParser(description=main.__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    imp = sub.add_parser("import", help="reference .pth training dir -> minimagen_tpu_torch dir")
    imp.add_argument("src")
    imp.add_argument("dst")
    exp = sub.add_parser("export", help="minimagen_tpu_torch training dir -> reference .pth files")
    exp.add_argument("src")
    exp.add_argument("dst")
    args = parser.parse_args(argv)

    from ..checkpoint import save_unet_checkpoint  # noqa: PLC0415
    from ..training import CKPT_EXT, create_directory  # noqa: PLC0415

    if args.cmd == "import":
        imagen = convert_reference_training_dir(args.src, device="cpu")
        create_directory(args.dst)
        shutil.copytree(os.path.join(args.src, "parameters"),
                        os.path.join(args.dst, "parameters"), dirs_exist_ok=True)
        for i in range(imagen.num_unets):
            save_unet_checkpoint(
                os.path.join(args.dst, "state_dicts", f"unet_{i}_state_imported.{CKPT_EXT}"),
                imagen.unets[i])
        print(f"imported {imagen.num_unets} unets from {args.src} -> {args.dst}")
    else:
        from ..generate import load_minimagen  # noqa: PLC0415

        imagen = load_minimagen(args.src, device="cpu")
        os.makedirs(args.dst, exist_ok=True)
        for i in range(imagen.num_unets):
            sd = export_unet_state_dict(imagen.unets[i].state_dict(), imagen.unet_configs[i])
            torch.save(sd, os.path.join(args.dst, f"unet_{i}_state_exported.pth"))
        print(f"exported {imagen.num_unets} unets from {args.src} -> {args.dst}")


if __name__ == "__main__":
    main()
