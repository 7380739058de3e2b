"""Training data of the port: the offline synthetic captioned-shapes set and
batch collation."""
