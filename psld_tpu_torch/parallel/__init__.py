"""Several processes (``psld_tpu/parallel``): ``distributed`` joins the
process group and holds the collectives and the (data, spatial) rank
grid, ``mesh`` places state and batches, ``fsdp`` shards the training
state, ``spatial`` splits each image's height over a spatial group."""
