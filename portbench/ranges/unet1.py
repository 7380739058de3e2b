"""A range around each call of the super-resolution U-Net, ``imagen.unets[1]``."""


def modules(imagen):
    return [imagen.unets[1]]
