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
  set, and ``training.train_lite``, the lite cascade's recipe (with a
  float32 Adam first moment where the committed run used bf16);
- the reference's default cascade (``generate.default_imagen``: the Base and
  Super presets at 64/128px, conditioned by t5_base through the hash text
  encoder) from a seeded init, sampled and trained like the lite one; every
  stem runs as the space-to-depth convolution (``ops/stem_conv.py``).

Every Pallas kernel of the JAX package (multi-query and multi-head
attention, forward and backward, with an optional mask bias; fused GroupNorm
forward and backward; depth-to-space with the stem bias) is a CUDA C++ kernel
under ``csrc/``, built with ``nvcc`` at first use and bound with ``ctypes``
(``ops/kernels.py``). ``ab_times.py`` times them, and guided lite steps,
for two checkouts on one card.

Activations are NHWC at every public function, as in the JAX package.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
