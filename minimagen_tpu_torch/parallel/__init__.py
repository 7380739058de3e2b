"""The multi-device modes on ``torch.distributed``, one process per device
(counterpart of ``minimagen_tpu/parallel/``): process groups and
collectives (``collectives``), meshes and the ZeRO-1 / FSDP plans
(``mesh``), several hosts (``multihost``), one device group per cascade
stage for training (``cascade``), a pipelined server (``pipeline``) and the
sharded full-state dumps of mesh runs (``checkpoint``)."""
