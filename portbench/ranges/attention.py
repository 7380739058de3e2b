"""A range around each call of the port's attention modules (``Attention``,
``CrossAttention``), with the shapes that entered it: what
``work.attention_bound`` reckons the work from."""
from portbench import program
from portbench.trace import param_bytes


def modules(imagen):
    attn, _ = program.module_classes()
    return [m for m in imagen.unets.modules() if isinstance(m, attn)]


def shape(module, args, kwargs):
    x = args[0]
    context = kwargs.get("context", args[1] if len(args) > 1 else None)
    kind = "self" if type(module).__name__ == "Attention" else "cross"
    ctx_shape = None if context is None else tuple(context.shape[1:])
    return (kind, tuple(x.shape), ctx_shape, x.element_size(), param_bytes(module),
            getattr(module, "heads", 8), hasattr(module, "context_norm"))
