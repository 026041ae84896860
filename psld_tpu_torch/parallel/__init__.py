"""Multi-process data parallelism and FSDP (``psld_tpu/parallel``):
``distributed`` joins the process group and holds the collectives,
``mesh`` places state and batches, ``fsdp`` shards the training state.
Spatial (height) parallelism is not ported."""
