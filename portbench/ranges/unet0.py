"""A range around each call of the base U-Net, ``imagen.unets[0]``."""


def modules(imagen):
    return [imagen.unets[0]]
