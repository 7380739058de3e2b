"""A range around each call of either U-Net, with the number of parameters
the U-Net holds and the fewest bytes one clip-Adam-EMA update of them moves:
per parameter the gradient read twice (the clip's norm, the update), the
master and both moments (the parameter's dtype) and the float32 EMA each
read and written once, 40 bytes for a float32 parameter
(``metrics/optimizer_roofline_pct.train.py``)."""


def modules(imagen):
    return list(imagen.unets)


def shape(module, args, kwargs):
    counted = getattr(module, "_portbench_update_bytes", None)
    if counted is None:
        params = list(module.parameters())
        counted = (sum(p.numel() for p in params),
                   sum(p.numel() * (8 * p.element_size() + 8) for p in params))
        module._portbench_update_bytes = counted
    return id(module), counted
