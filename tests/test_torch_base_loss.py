"""Settles whether the fresh Base's loss jump after its first Adam steps is
the JAX package's own: the Base preset at dim 64 (its full topology: four
levels, three ResnetBlocks each, attention on the lower three), one stage
at 16px, float32, the same seeded init in both packages, three train steps
of clip-50 Adam at the default recipe's learning rate (1e-4) on the same
batch with the JAX step's draws injected into the port's step. The losses
agree to 1e-4 relative, so a jump the port shows at this width is the JAX
package's too.

The JAX side is its train step's arithmetic (``mesh.py:346-357``): the
stage loss's gradient at the step's key, then ``make_optimizer``'s
clip-50 Adam, here over the parameters raveled into one vector, which
compiles in a second where the per-leaf update over Base's ~1000 leaves
takes ~15 s (the update is elementwise but for the clip's global norm)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
import torch_mesh_workers as W
from jax.flatten_util import ravel_pytree
from test_torch_parallel import _jax_draws

from minimagen_tpu.models import unet as J
from minimagen_tpu.models.imagen import Imagen as JImagen
from minimagen_tpu.parallel import mesh as jmesh
from minimagen_tpu_torch import training as ttrain
from minimagen_tpu_torch.checkpoint import flax_unet_tree
from minimagen_tpu_torch.models.imagen import Imagen
from minimagen_tpu_torch.models.unet import Base

DIM, SIZE, BATCH, STEPS, LR = 64, 16, 2, 3, 1e-4
KW = dict(image_sizes=(SIZE,), timesteps=1000, cond_drop_prob=0.15, text_encoder_name="t5_small")


def test_the_base_loss_sequence_is_the_jax_packages():
    torch.manual_seed(0)
    ours = Imagen(unets=[Base(dim=DIM)], device="cpu", **KW)
    ref = JImagen(unets=[J.Base(dim=DIM)], **KW)
    flat, unravel = ravel_pytree(jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                                        flax_unet_tree(ours.unets[0])))
    b = W.batch(BATCH, seed=5)
    b["image"] = b["image"][:, :SIZE, :SIZE]
    key = jax.random.PRNGKey(7)
    grad_fn = jax.jit(jax.value_and_grad(ref.stage_loss_fn(0)))
    opt = jmesh.make_optimizer(LR)
    update = jax.jit(opt.update)
    opt_state = opt.init(flat)
    jax_losses = []
    for step in range(STEPS):
        stage_key = jax.random.split(jax.random.fold_in(key, step), 1)[0]
        loss, grads = grad_fn(unravel(flat), *(jnp.asarray(b[k]) for k in
                                               ("image", "encoding", "mask")), stage_key)
        updates, opt_state = update(ravel_pytree(grads)[0], opt_state, flat)
        flat = optax.apply_updates(flat, updates)
        jax_losses.append(float(loss))

    opt_t = ttrain.make_optimizer(LR)
    tstate = ttrain.create_train_state(ours, opt_t)
    tstep = ttrain.make_train_step(ours, opt_t)
    losses = []
    for step in range(STEPS):
        draws = [{k: torch.tensor(v) for k, v in d.items()}
                 for d in _jax_draws(ref, key, step, BATCH)]
        tstate, l_ = tstep(tstate, W.torch_batch(b), draws=draws)
        losses.append(float(l_[0]))
    print(f"Base dim {DIM} at {SIZE}px, batch {BATCH}: port {losses}, JAX {jax_losses}")
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
