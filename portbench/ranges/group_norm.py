"""A range around each call of the port's ``GroupNorm`` modules (normalise,
time scale-shift, SiLU), with the shapes that entered it: what
``work.group_norm_bound`` reckons the work from."""
from portbench import program
from portbench.trace import param_bytes


def modules(imagen):
    _, gn = program.module_classes()
    return [m for m in imagen.unets.modules() if isinstance(m, gn)]


def shape(module, args, kwargs):
    x = args[0]
    ss = kwargs.get("scale_shift", args[1] if len(args) > 1 else None)
    return (tuple(x.shape), x.element_size(), param_bytes(module), ss is not None)
