"""Host-side C code of the port (no CUDA): ``zstd_decode.c``, loaded by
:mod:`minimagen_tpu_torch.host.zstd`."""
