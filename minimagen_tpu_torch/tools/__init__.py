"""Tools: the reference MinImagen checkpoint importer and exporter
(``torch_import``)."""
