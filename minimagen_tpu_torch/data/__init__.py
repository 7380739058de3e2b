"""Training data of the port: the offline synthetic captioned-shapes set and
the offline dataset factory (``dataset.py``), collation and the loader
(``collate.py``), the npz cache (``cache.py``) and the native resize
library's loader (``native.py``)."""
