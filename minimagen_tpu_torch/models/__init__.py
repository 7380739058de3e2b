"""Models of the port: layers, the U-Net, the T5 encoder and cascade sampling."""
