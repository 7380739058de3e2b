"""minimagen_tpu_torch — the PyTorch/CUDA port of ``minimagen_tpu``.

A second package beside the JAX one, for one NVIDIA H100. It mirrors the JAX
package's layout (``ops/``, ``models/``, ``data/``) so each counterpart is
easy to find, and it imports neither ``jax`` nor anything of
``minimagen_tpu``: what it needs from there is copied.

What is ported so far:

- sampling through the committed lite cascade: the tiny T5 encoder, the 64px
  base and 256px super-resolution U-Nets, pair-batched classifier-free
  guidance with dynamic thresholding, and the DDPM/DDIM samplers with
  truncated super-resolution;
- training on one device: the per-stage loss (l1/l2/huber, min-SNR, offset
  noise), clip-50 Adam with a float32 EMA, the synthetic captioned-shapes
  set, and ``training.train_lite``, the lite cascade's recipe (Adam's first
  moment float32 by default, bf16 as the committed run kept it on request);
- the reference's default cascade (``generate.default_imagen``: the Base and
  Super presets at 64/128px, conditioned by t5_base through the hash text
  encoder) from a seeded init, sampled and trained like the lite one; every
  stem runs as the space-to-depth convolution (``ops/stem_conv.py``);
- the training harness and the CLIs: ``training.MinimagenTrain`` (training
  directories, validation, best and latest checkpoints, full-state restart,
  a per-batch watchdog), optax's clip-50 Adam with gradient accumulation
  and a bf16 first moment, flax-msgpack checkpoint writing that the JAX
  package reads (``checkpoint.py``), ``generate.load_minimagen`` and
  ``sample_and_save``, and ``python -m minimagen_tpu_torch.train`` /
  ``.inference`` / ``.main``, the root CLIs' counterparts;
- the multi-device modes on ``torch.distributed``, one process per device
  (``parallel/``): data parallelism, ZeRO-1 and FSDP over a mesh's data
  axis, ``Imagen.sample(mesh=)``, cascade-stage training groups, the
  pipelined cascade server, several hosts, and ``--MESH data`` in the CLIs
  under ``torchrun``; tensor parallelism over a ``model`` axis
  (``make_mesh(model_parallel=)``: the JAX package's rule splits wide
  kernels over it, ``parallel/tensor.py`` computes their column-parallel
  forward), alone or with ZeRO-1, in training, sampling, the cascade
  groups, the pipeline and the sharded dumps;
- the tools: ``Imagen.stage_memory_analysis``, ``utils/profiling.py``
  (``torch.profiler`` traces and their device time by kernel family) and
  ``tools/torch_import.py`` (reference MinImagen ``.pth`` U-Nets in and
  out, ``python -m minimagen_tpu_torch.tools.torch_import import|export``);
- the reference's import paths (``Imagen``, ``Unet``, ``t5``,
  ``diffusion_model``, ``helpers``, ``layers``): ``from
  minimagen_tpu_torch.Unet import Unet, Base`` works as the reference's
  ``from minimagen.Unet import ...`` does.

Every Pallas kernel of the JAX package (multi-query and multi-head
attention, forward and backward, with an optional mask bias; fused GroupNorm
forward and backward; depth-to-space with the stem bias) is a CUDA C++ kernel
under ``csrc/``, built with ``nvcc`` at first use and bound with ``ctypes``
(``ops/kernels.py``). ``ab_times.py`` times them, and guided lite steps,
for two checkouts on one card.

Activations are NHWC at every public function, as in the JAX package.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

# the reference's import paths (its minimagen/__init__.py exports these modules)
from . import Imagen, Unet, diffusion_model, helpers, layers, t5  # noqa: E402,F401

__version__ = "0.1.0"
